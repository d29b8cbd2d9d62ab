"""Multiscale transformer encoder-decoder closure model with latent SDE.

Counterpart of ``swirlfem_tpu/models/transformer.py`` (`pooled_heads` to
`Model`, :35-679): an MViT-style multiscale transformer over mesh elements
(pooled-attention downsampling blocks, tile-upsampled attention blocks,
encoder/decoder stacks with doubling heads and max-pool/tile skips, learned
positional embeddings), an optional latent-SDE processor between encoder
and decoder, and the top-level `Model` mapping per-element velocity patches
to a forcing correction plus KL diagnostics.

Submodules carry the flax module names (``multiscale_encoder.block_0.
PooledSelfAttention_0.query``, ...), so that `interop.
transformer_params_from_flax` maps a flax parameter tree onto the
`state_dict` name by name; `nn.Linear` keeps its weight as (out, in).
What the flax code implies and is written out here:

* ``nn.gelu`` is the tanh approximation; ``nn.LayerNorm`` has eps 1e-6;
* flax's pooling with a length-2 window on a (B, N, C) input pools over
  (B, N), the batch axis with window 1; ``padding='same'`` puts the low pad
  at total // 2, and the average counts the padding;
* ``jnp.tile(y, (4, 1))`` on (B, N, C) repeats the whole token sequence;
* ``nn.dot_product_attention`` scales q by 1/sqrt(head_dim), softmax over
  the keys (an einsum and a softmax here; the JAX package has no kernel
  for it);
* in `MlpBlock` the output layer is built first, so it is ``Dense_0``.

Randomness: the SDE processor's prior noise and Brownian increments come
from an explicit ``torch.Generator``, or are passed in (``draws``), so that
a test can feed the JAX package's draws.  ``dtype=torch.bfloat16`` runs the
encoder and decoder blocks under ``torch.autocast`` (the flax modules that
take `dtype`); the embedding, the norms after each stack, the processor and
the output head stay float32, as do the parameters.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from swirlfem_tpu_torch.sde.nn_sde import NNSDE
from swirlfem_tpu_torch.sde.sdeint import brownian_path


def gelu(x):
  return F.gelu(x, approximate='tanh')


# -- initializers (flax's families) ------------------------------------------


def dense(in_features: int, out_features: int, *, bias: bool = True,
          kernel: str = 'lecun', bias_std: float = 0.0) -> nn.Linear:
  """An `nn.Linear` initialised as flax's Dense with the given families:
  kernel 'lecun' (truncated normal, fan in), 'xavier' or 'zeros'; bias
  normal(bias_std) (zeros at 0)."""
  layer = nn.Linear(in_features, out_features, bias=bias)
  with torch.no_grad():
    if kernel == 'lecun':
      std = math.sqrt(1.0 / in_features) / .87962566103423978
      nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    elif kernel == 'xavier':
      nn.init.xavier_uniform_(layer.weight)
    else:
      layer.weight.zero_()
    if bias:
      if bias_std:
        layer.bias.normal_(0.0, bias_std)
      else:
        layer.bias.zero_()
  return layer


def layer_norm(features: int, bias: bool = True) -> nn.LayerNorm:
  return nn.LayerNorm(features, eps=1e-6, bias=bias)


def _autocast(x: torch.Tensor, dtype):
  if dtype is None or dtype == torch.float32:
    return contextlib.nullcontext()
  return torch.autocast(x.device.type, dtype=dtype)


# -- pooling and attention ---------------------------------------------------


def _pool_axis(x, axis: int, window: int, stride: int, mode: str):
  """XLA-SAME pooling of one axis (low pad total // 2; max pads with -inf,
  the average sums the zero padding and divides later)."""
  n = x.shape[axis]
  out = -(-n // stride)
  total = max((out - 1) * stride + window - n, 0)
  if window == 1 and stride == 1:
    return x
  lo = total // 2
  pad = [0, 0] * (x.ndim - 1 - axis) + [lo, total - lo]
  x = F.pad(x, pad, value=-math.inf if mode == 'max' else 0.0)
  win = x.unfold(axis, window, stride)
  return win.amax(-1) if mode == 'max' else win.sum(-1)


def pooled_heads(x: torch.Tensor, window, strides, mode: str,
                 num_heads: int) -> torch.Tensor:
  """Optionally pools the (B, N) grid of a (B, N, C) input, then splits
  heads: (B, N', H, C/H)."""
  head_dim = x.shape[-1] // num_heads
  if mode == 'none' or not window or int(np.prod(window)) == 1:
    return x.reshape(x.shape[:-1] + (num_heads, head_dim))
  if mode not in ('avg', 'max'):
    raise ValueError(f'unknown pool mode: {mode}')
  for axis, (w, s) in enumerate(zip(window, strides)):
    x = _pool_axis(x, axis, w, s, mode)
  if mode == 'avg':
    x = x / float(np.prod(window))
  return x.reshape(x.shape[:-1] + (num_heads, head_dim))


def dot_product_attention(q, k, v):
  """softmax(q k^T / sqrt(d)) v over (B, N, H, D) heads."""
  q = q / math.sqrt(q.shape[-1])
  weights = torch.softmax(torch.einsum('bqhd,bkhd->bhqk', q, k), dim=-1)
  return torch.einsum('bhqk,bkhd->bqhd', weights, v)


# -- blocks ------------------------------------------------------------------


class MlpBlock(nn.Module):
  """Feed-forward block (dense -> gelu -> dense); `Dense_0` is the output
  layer, as flax names them."""

  def __init__(self, in_dim: int, mlp_dim: int, out_dim: int | None = None,
               use_bias: bool = True):
    super().__init__()
    out_dim = in_dim if out_dim is None else out_dim
    self.Dense_0 = dense(mlp_dim, out_dim, bias=use_bias, kernel='xavier',
                         bias_std=1e-6)
    self.Dense_1 = dense(in_dim, mlp_dim, bias=use_bias, kernel='xavier',
                         bias_std=1e-6)

  def forward(self, x):
    return self.Dense_0(gelu(self.Dense_1(x)))


class PooledSelfAttention(nn.Module):
  """Downsampling attention: queries pooled to a coarser token grid."""

  def __init__(self, features: int, num_heads: int, pool_q, pool_kv,
               stride_q, stride_kv, use_bias: bool = False):
    super().__init__()
    self.num_heads = num_heads
    self.pool_q, self.pool_kv = tuple(pool_q), tuple(pool_kv)
    self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
    for name in ('query', 'key', 'value', 'out'):
      setattr(self, name, dense(features, features, bias=use_bias))

  def forward(self, x):
    pool = lambda y, w, s: pooled_heads(y, w, s, 'avg', self.num_heads)
    q = pool(self.query(x), self.pool_q, self.stride_q)
    k = pool(self.key(x), self.pool_kv, self.stride_kv)
    v = pool(self.value(x), self.pool_kv, self.stride_kv)
    # MViTv2 residual pooling: the queries added to the attention.
    out = dot_product_attention(q, k, v) + q
    return self.out(out.flatten(-2))


class TiledSelfAttention(nn.Module):
  """Upsampling attention: q/k/v tiled to a finer token grid."""

  def __init__(self, features: int, num_heads: int, tile_reps,
               use_bias: bool = False):
    super().__init__()
    self.num_heads, self.tile_reps = num_heads, tuple(tile_reps)
    for name in ('query', 'key', 'value', 'out'):
      setattr(self, name, dense(features, features, bias=use_bias))

  def forward(self, x):
    def tiled(y):
      y = y.tile(self.tile_reps)
      return y.reshape(y.shape[:2] + (self.num_heads, -1))

    q, k, v = tiled(self.query(x)), tiled(self.key(x)), tiled(self.value(x))
    out = dot_product_attention(q, k, v) + q  # residual queries
    return self.out(out.flatten(-2))


class EncoderBlock(nn.Module):
  """Pre-norm block: pooled attention + max-pool skip, then MLP."""

  def __init__(self, in_dim: int, out_dim: int, num_heads: int, pool_q,
               pool_kv, stride_q, stride_kv, use_bias: bool = False):
    super().__init__()
    self.num_heads, self.stride_q = num_heads, tuple(stride_q)
    self.LayerNorm_0 = layer_norm(in_dim, use_bias)
    self.PooledSelfAttention_0 = PooledSelfAttention(
        in_dim, num_heads, pool_q, pool_kv, stride_q, stride_kv,
        use_bias=use_bias)
    self.LayerNorm_1 = layer_norm(in_dim, use_bias)
    self.MlpBlock_0 = MlpBlock(in_dim, in_dim * 4, out_dim, use_bias)
    if out_dim != in_dim:
      self.project_skip = dense(in_dim, out_dim, bias=use_bias)

  def forward(self, x):
    inputs = x
    x = self.PooledSelfAttention_0(self.LayerNorm_0(x))
    if self.stride_q and int(np.prod(self.stride_q)) > 1:
      # Skip connections across a resolution change always max-pool.
      skip = pooled_heads(
          inputs, tuple(s + 1 if s > 1 else s for s in self.stride_q),
          self.stride_q, 'max', self.num_heads)
      skip = skip.flatten(-2)
    else:
      skip = inputs
    x = x + skip
    x_norm = self.LayerNorm_1(x)
    y = self.MlpBlock_0(x_norm)
    if hasattr(self, 'project_skip'):
      return y + self.project_skip(x_norm)
    return y + x


class DecoderBlock(nn.Module):
  """Pre-norm block: tiled attention + tiled skip, then MLP."""

  def __init__(self, in_dim: int, out_dim: int, num_heads: int, tile_reps,
               use_bias: bool = False):
    super().__init__()
    self.tile_reps = tuple(tile_reps)
    self.LayerNorm_0 = layer_norm(in_dim, use_bias)
    self.TiledSelfAttention_0 = TiledSelfAttention(in_dim, num_heads,
                                                   tile_reps,
                                                   use_bias=use_bias)
    self.LayerNorm_1 = layer_norm(in_dim, use_bias)
    self.MlpBlock_0 = MlpBlock(in_dim, in_dim * 4, out_dim, use_bias)
    if out_dim != in_dim:
      self.project_skip = dense(in_dim, out_dim, bias=use_bias)

  def forward(self, x):
    inputs = x
    x = self.TiledSelfAttention_0(self.LayerNorm_0(x))
    skip = (inputs.tile(self.tile_reps)
            if int(np.prod(self.tile_reps)) > 1 else inputs)
    x = x + skip
    x_norm = self.LayerNorm_1(x)
    y = self.MlpBlock_0(x_norm)
    if hasattr(self, 'project_skip'):
      return y + self.project_skip(x_norm)
    return y + x


class MultiscaleEncoder(nn.Module):
  """Stack of EncoderBlocks; pooling layers shrink tokens, double width and
  heads."""

  def __init__(self, width: int, depth: int, pooling_layers, pooling_kernel,
               pooling_strides_q, initial_kv_pooling_strides,
               num_initial_heads: int = 1, use_bias: bool = False,
               dtype=None):
    super().__init__()
    self.pooling_layers, self.dtype = tuple(pooling_layers), dtype
    num_heads, dim = num_initial_heads, width
    stride_kv = tuple(initial_kv_pooling_strides)
    for layer in range(depth):
      out_dim = dim
      pool_q = tuple(pooling_kernel)
      if layer in pooling_layers:
        num_heads *= 2
        stride_kv = tuple((s // 2) if s > 1 else 1 for s in stride_kv)
        stride_q = tuple(pooling_strides_q)
      else:
        stride_q = tuple(1 for _ in pooling_strides_q)
      if layer + 1 in pooling_layers:
        out_dim = dim * 2
      self.add_module(f'block_{layer}', EncoderBlock(
          dim, out_dim, num_heads, pool_q, pooling_kernel, stride_q,
          stride_kv, use_bias))
      dim = out_dim
    self.depth = depth
    self.encoder_norm = layer_norm(dim, use_bias)

  def forward(self, x):
    skips = {}
    with _autocast(x, self.dtype):
      for layer in range(self.depth):
        if layer in self.pooling_layers:
          skips[layer] = x
        x = getattr(self, f'block_{layer}')(x)
    return self.encoder_norm(x.float()), skips


class MultiscaleDecoder(nn.Module):
  """Mirror of the encoder: upsampling blocks with skip residuals."""

  def __init__(self, width: int, depth: int, pooling_layers, qkv_tile_reps,
               use_bias: bool = False, use_residuals: bool = True,
               dtype=None):
    super().__init__()
    self.pooling_layers, self.dtype = tuple(pooling_layers), dtype
    self.use_residuals, self.depth = use_residuals, depth
    dim = width * 2 ** len(pooling_layers)
    for layer in reversed(range(depth)):
      out_dim = dim
      tile_reps = (tuple(qkv_tile_reps) if layer in pooling_layers
                   else tuple(1 for _ in qkv_tile_reps))
      if layer + 1 in pooling_layers:
        out_dim = dim // 2
      self.add_module(f'decoder_block_{layer}', DecoderBlock(
          dim, out_dim, dim // width, tile_reps, use_bias))
      dim = out_dim
    self.decoder_norm = layer_norm(dim, use_bias)

  def forward(self, x, skips):
    with _autocast(x, self.dtype):
      for layer in reversed(range(self.depth)):
        x = getattr(self, f'decoder_block_{layer}')(x)
        if layer in self.pooling_layers and self.use_residuals:
          x = x + skips[layer]
    return self.decoder_norm(x.float())


class AddPosEmbs(nn.Module):
  """Learned positional embeddings over the token axis."""

  def __init__(self, num_tokens: int, features: int):
    super().__init__()
    self.pos_embedding = nn.Parameter(
        0.02 * torch.randn(1, num_tokens, features))

  def forward(self, x):
    return x + self.pos_embedding


class Encoder1DBlock(nn.Module):
  """Plain pre-norm transformer encoder block (no pooling)."""

  def __init__(self, features: int, mlp_dim: int, num_heads: int):
    super().__init__()
    self.num_heads = num_heads
    self.LayerNorm_0 = layer_norm(features)
    self.MultiHeadDotProductAttention_0 = nn.Module()
    for name in ('query', 'key', 'value', 'out'):
      setattr(self.MultiHeadDotProductAttention_0, name,
              dense(features, features, kernel='xavier'))
    self.LayerNorm_1 = layer_norm(features)
    self.MlpBlock_0 = MlpBlock(features, mlp_dim)

  def forward(self, x):
    mha = self.MultiHeadDotProductAttention_0
    y = self.LayerNorm_0(x)
    heads = lambda t: t.reshape(t.shape[:-1] + (self.num_heads, -1))
    y = dot_product_attention(heads(mha.query(y)), heads(mha.key(y)),
                              heads(mha.value(y)))
    x = x + mha.out(y.flatten(-2))
    return x + self.MlpBlock_0(self.LayerNorm_1(x))


# -- latent SDE processor ----------------------------------------------------


def _divide_no_nan(x, y):
  zero = torch.isclose(y, torch.zeros_like(y))
  return torch.where(zero, torch.zeros_like(x),
                     x / torch.where(zero, torch.ones_like(y), y))


def diag_gaussian_kl(mean_q, std_q, mean_p, std_p):
  """KL(N(mean_q, diag std_q^2) || N(mean_p, diag std_p^2)), closed form."""
  var_ratio = torch.square(std_q / std_p)
  t1 = torch.square((mean_q - mean_p) / std_p)
  return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


class MLP(nn.Module):
  """Small MLP with zero-init kernels (stable closure-model start)."""

  def __init__(self, in_features: int, features, activation_fn=gelu,
               final_activation_fn=None, bias_stddev: float = 1e-6):
    super().__init__()
    self.activation_fn = activation_fn
    self.final_activation_fn = final_activation_fn
    self.num = len(features)
    for i, feat in enumerate(features):
      self.add_module(f'Dense_{i}', dense(in_features, feat, kernel='zeros',
                                          bias_std=bias_stddev))
      in_features = feat

  def forward(self, x):
    for i in range(self.num):
      x = getattr(self, f'Dense_{i}')(x)
      if i < self.num - 1:
        x = self.activation_fn(x)
    return x if self.final_activation_fn is None else (
        self.final_activation_fn(x))


class Drift(nn.Module):
  """Drift network of the latent SDE (tanh output for stability)."""

  def __init__(self, in_features: int, features):
    super().__init__()
    self.MLP_0 = MLP(in_features, features, final_activation_fn=torch.tanh)

  def forward(self, x, context=None):
    if context is not None:
      x = torch.cat([x, context], dim=-1)
    return self.MLP_0(x)


class Diffusion(nn.Module):
  """Strongly-diagonal diffusion: per-coordinate independent positive MLPs."""

  def __init__(self, features, ndim: int):
    super().__init__()
    self.ndim = ndim
    for i in range(ndim):
      self.add_module(f'coord_{i}', MLP(1, features,
                                        final_activation_fn=torch.exp))

  def forward(self, x):
    return torch.cat([getattr(self, f'coord_{i}')(x[..., i:i + 1])
                      for i in range(self.ndim)], dim=-1)


class VariationalDriftDiffusion(nn.Module):
  """Posterior/prior drifts + diagonal diffusion + pathwise KL integrand.

  The state is ``[z; logqp]`` (batch first); the augmented drift appends
  the Girsanov KL integrand ``0.5 ||(post - prior) / sigma||^2``.  As in
  the JAX package, the integration is deterministic: sigma enters only
  through the KL integrand.
  """

  def __init__(self, prior_drift_features, post_drift_features,
               diffusion_features, context_size: int):
    super().__init__()
    latent = post_drift_features[-1]
    self.latent_size = latent
    self.post_drift = Drift(latent + context_size, post_drift_features)
    self.prior_drift = Drift(latent, prior_drift_features)
    self.diffusion = Diffusion(diffusion_features, latent)

  def forward(self, state, t, dw, context):
    del t, dw
    z = state[..., :self.latent_size]
    post = self.post_drift(z, context)
    prior = self.prior_drift(z)
    sigma = self.diffusion(z)
    logqp = 0.5 * torch.sum(torch.square(_divide_no_nan(post - prior, sigma)),
                            dim=-1, keepdim=True)
    aug_drift = torch.cat([post, logqp], dim=-1)
    return aug_drift, torch.zeros_like(aug_drift)


class TransformerDynamics(nn.Module):
  """Transformer-parameterized drift over a sequence-valued latent state
  (batch first: ``state`` is (B, S L + 1))."""

  def __init__(self, num_layers: int, latent_size: int,
               hidden_size: int = 32):
    super().__init__()
    self.num_layers, self.latent_size = num_layers, latent_size
    for name in ('post', 'prior'):
      for layer in range(num_layers):
        self.add_module(f'{name}_block_{layer}', Encoder1DBlock(
            latent_size, latent_size, num_heads=2))
      self.add_module(f'{name}_norm', layer_norm(latent_size))
      self.add_module(f'{name}_out', dense(latent_size, latent_size,
                                           kernel='zeros', bias_std=1e-6))
    self.diffusion_mlp = MLP(1, (hidden_size,) * num_layers + (1,),
                             activation_fn=torch.tanh,
                             final_activation_fn=torch.exp)

  def _block(self, x, name):
    for layer in range(self.num_layers):
      x = getattr(self, f'{name}_block_{layer}')(x)
    x = getattr(self, f'{name}_norm')(x)
    return getattr(self, f'{name}_out')(x)

  def forward(self, state, t, dw, context):
    b = state.shape[0]
    latent = state[:, :-1]
    x = latent.reshape(b, -1, self.latent_size)
    seq_len = x.shape[1]
    t_token = t.reshape(1, 1, 1).expand(b, 1, self.latent_size).to(x.dtype)
    x_t = torch.cat([x, t_token], dim=1)
    ctx = context.reshape(b, seq_len, self.latent_size)
    post = self._block(torch.cat([x_t, ctx], dim=1), 'post')
    prior = self._block(x_t, 'prior')
    post = post[:, :seq_len].reshape(b, -1)
    prior = prior[:, :seq_len].reshape(b, -1)
    sigma = self.diffusion_mlp(latent[..., None]).reshape(b, -1)
    logqp = 0.5 * torch.sum(torch.square(_divide_no_nan(post - prior, sigma)),
                            dim=-1, keepdim=True)
    aug_drift = torch.cat([post, logqp], dim=-1)
    aug_diffusion = torch.cat([dw * sigma, torch.zeros_like(logqp)], dim=-1)
    return aug_drift, aug_diffusion


_TS = (0.0, 1.0)


def _swap_leading(dw):
  """Swaps the samples and the time axes of Brownian increments: the JAX
  layout (samples, gridpoints, width) and the integrator's time-first
  (gridpoints, samples, width), either way."""
  return dw.transpose(0, 1)


class LatentSDE(nn.Module):
  """Stochastic processor: encode -> integrate latent SDE -> decode.

  `cfg` has the fields num_gridpoints, latent_size, context_size,
  data_size, prior_scale, use_transformer, num_layers, num_sde_layers,
  hidden_size, num_samples.  `in_features` is the width of its input (the
  encoder's output width, or the flattened tokens for the MLP variant).

  `draws` (optional): ``{'noise': (B, num_samples, S L), 'dw': (B
  num_samples, num_gridpoints, S L)}`` for the SDE path, ``{'dw': ...}``
  for the MLP path, in the JAX package's layouts; otherwise they are drawn
  from `generator`.
  """

  def __init__(self, cfg, in_features: int):
    super().__init__()
    self.cfg = cfg
    if cfg.use_transformer:
      self.sde = NNSDE(TransformerDynamics(num_layers=cfg.num_sde_layers,
                                           latent_size=cfg.latent_size))
      return
    h = cfg.hidden_size
    self.sde_encoder_mlp = MLP(
        in_features, (h,) * cfg.num_layers
        + (2 * cfg.latent_size + cfg.context_size,), final_activation_fn=gelu)
    self.sde = NNSDE(VariationalDriftDiffusion(
        prior_drift_features=(h,) * cfg.num_sde_layers + (cfg.latent_size,),
        post_drift_features=(h, cfg.latent_size),
        diffusion_features=(h,) * cfg.num_sde_layers + (1,),
        context_size=cfg.context_size))
    self.sde_decoder_mlp = MLP(cfg.latent_size,
                               (h,) * cfg.num_layers + (cfg.data_size,),
                               final_activation_fn=gelu)

  def sample_draws(self, batch_size: int, seq_len: int, generator=None,
                   device=None):
    """The draws of one call on `batch_size` inputs of `seq_len` tokens, in
    the JAX package's layouts (see the class docstring); None where the
    path draws nothing (the ODE path)."""
    cfg = self.cfg
    expanded = batch_size * cfg.num_samples
    width = (seq_len * cfg.latent_size if cfg.use_transformer
             else cfg.latent_size)
    if cfg.use_transformer and cfg.num_samples <= 1:
      return None
    dw = brownian_path(cfg.num_gridpoints, (expanded, width),
                       generator=generator, device=device)
    draws = {'dw': _swap_leading(dw)}
    if cfg.use_transformer:
      draws['noise'] = torch.randn((batch_size, cfg.num_samples, width),
                                   generator=generator, device=device)
    return draws

  @staticmethod
  def _dw(draws, like):
    """Time-first Brownian increments (gridpoints, samples, width)."""
    return _swap_leading(torch.as_tensor(draws['dw'], dtype=like.dtype,
                                       device=like.device))

  def forward(self, inputs, generator=None, draws=None):
    cfg = self.cfg
    b = inputs.shape[0]
    if draws is None:
      draws = self.sample_draws(
          b, inputs.shape[1] if cfg.use_transformer else 1, generator,
          inputs.device)
    if cfg.use_transformer:
      if inputs.shape[-1] != cfg.latent_size:
        raise ValueError(
            f'encoder output width {inputs.shape[-1]} != processor '
            f'latent_size {cfg.latent_size}')
      seq_len = inputs.shape[1]
      z0 = inputs.reshape(b, -1)
      if cfg.num_samples > 1:
        z1, kl_path, kl_q0 = self._sample_sde_transformer(z0, draws)
      else:
        z1 = self._sample_ode_transformer(z0)
        kl_path = torch.zeros((b, 1), dtype=torch.float32,
                              device=inputs.device)
        kl_q0 = torch.zeros((b,), dtype=torch.float32, device=inputs.device)
      z1 = z1.reshape(b, cfg.num_samples, seq_len, cfg.latent_size)
      aux = {
          'kl_q0': kl_q0,
          'kl_path': kl_path.mean(dim=-1),
          'z0_means': z0.mean(dim=-1),
          'z1_means': z1.reshape(b, -1).mean(dim=-1),
          # Spread across the SDE draws: 0 means the stochastic paths have
          # collapsed (posterior-collapse telltale).
          'z1_stds': z1.std(dim=1, unbiased=False).reshape(b, -1).mean(-1),
      }
      return z1, aux

    hidden = self.sde_encoder_mlp(inputs)
    q0_mean, q0_logstd, context = torch.split(
        hidden, [cfg.latent_size, cfg.latent_size, cfg.context_size], dim=-1)
    q0_std = torch.exp(q0_logstd)
    kl_q0 = diag_gaussian_kl(q0_mean, q0_std, torch.zeros_like(q0_mean),
                             cfg.prior_scale * torch.ones_like(q0_std))
    z0 = q0_mean[:, None, :].expand(b, cfg.num_samples, cfg.latent_size)
    z1, kl_path = self._sample_mlp(z0, context, draws)
    y = self.sde_decoder_mlp(z1)
    return y, {'kl_q0': kl_q0, 'kl_path': kl_path}

  def _sample_mlp(self, z0, context, draws):
    cfg = self.cfg
    b = z0.shape[0]
    expanded = b * cfg.num_samples
    z0 = z0.reshape(expanded, cfg.latent_size)
    context = context[:, None, :].expand(
        b, cfg.num_samples, cfg.context_size).reshape(expanded, -1)
    init = torch.cat([z0, z0.new_zeros(expanded, 1)], dim=-1)
    dw = self._dw(draws, z0)
    states = self.sde(init, _TS, dw, context)
    z1 = states[0, :, :cfg.latent_size].reshape(b, cfg.num_samples, -1)
    kl_path = states[0, :, -1].reshape(b, cfg.num_samples)
    return z1, kl_path.sum(dim=-1)

  def _sample_ode_transformer(self, z0):
    # Deterministic path: the dynamics with zero noise, no KL.
    dw = z0.new_zeros((self.cfg.num_gridpoints,) + tuple(z0.shape))
    aug0 = torch.cat([z0, z0.new_zeros(z0.shape[0], 1)], dim=-1)
    aug1 = self.sde(aug0, _TS, dw, z0)
    return aug1[0, :, :-1][:, None, :]

  def _sample_sde_transformer(self, z0, draws):
    cfg = self.cfg
    b, expanded_latent = z0.shape
    expanded = b * cfg.num_samples
    noise = torch.as_tensor(draws['noise'], dtype=z0.dtype, device=z0.device)
    samples = z0[:, None, :] + cfg.prior_scale * noise
    scale = cfg.prior_scale * torch.ones_like(z0)
    kl_q0 = diag_gaussian_kl(z0, scale, torch.zeros_like(z0), scale)
    samples = samples.reshape(expanded, expanded_latent)
    dw = self._dw(draws, z0)
    aug0 = torch.cat([samples, samples.new_zeros(expanded, 1)], dim=-1)
    aug1 = self.sde(aug0, _TS, dw, samples)
    z1 = aug1[0, :, :expanded_latent].reshape(b, cfg.num_samples, -1)
    kl_path = aug1[0, :, -1].reshape(b, cfg.num_samples)
    return z1, kl_path, kl_q0


# -- the model ---------------------------------------------------------------


AUX_KEYS = ('kl_path', 'kl_q0', 'z0_means', 'z1_means', 'z1_stds')


class Model(nn.Module):
  """Top-level closure model: element patches -> forcing correction + aux.

  Inputs are ``(batch, num_elements, patch_dim)`` per-element velocity
  patches; outputs a same-shaped forcing correction and a dict of
  KL/latent diagnostics, each of shape (batch,).
  """

  def __init__(self, *, num_elements: int, num_channels: int, depth: int,
               width: int, pooling_layers, pooling_kernel, pooling_strides_q,
               initial_kv_pooling_strides, qkv_tile_reps,
               processor_config: Any, num_initial_heads: int = 1,
               use_residuals: bool = True, use_bias: bool = False,
               dtype=None, mean_after_decoder: bool = False,
               freeze_encoder: bool = False):
    super().__init__()
    self.depth, self.processor_config = depth, processor_config
    self.mean_after_decoder = mean_after_decoder
    self.freeze_encoder = freeze_encoder
    self.embedding = dense(num_channels, width)
    self.encoder_posembed = AddPosEmbs(num_elements, width)
    if depth > 0:
      self.multiscale_encoder = MultiscaleEncoder(
          width, depth, pooling_layers, pooling_kernel, pooling_strides_q,
          initial_kv_pooling_strides, num_initial_heads, use_bias, dtype)
      if processor_config.num_samples > 0:
        tokens = num_elements
        for layer in range(depth):
          if layer in pooling_layers:
            tokens = -(-tokens // int(np.prod(pooling_strides_q)))
        channels = width * 2 ** len(pooling_layers)
        self.tok_shape = (tokens, channels)
        in_features = (channels if processor_config.use_transformer
                       else tokens * channels)
        self.LatentSDE_0 = LatentSDE(processor_config, in_features)
      self.multiscale_decoder = MultiscaleDecoder(
          width, depth, pooling_layers, qkv_tile_reps, use_bias,
          use_residuals, dtype)
    self.decoded_patches = dense(width, num_channels, kernel='zeros',
                                 bias_std=1e-6)

  def sample_draws(self, batch_size: int, generator=None, device=None):
    """The processor's draws for one call on `batch_size` inputs (see
    `LatentSDE`), or None where the model draws nothing."""
    if self.depth == 0 or self.processor_config.num_samples <= 0:
      return None
    return self.LatentSDE_0.sample_draws(batch_size, self.tok_shape[0],
                                         generator, device)

  def forward(self, inputs, generator=None, draws=None):
    """`generator` draws the processor's noise; `draws` passes it in (see
    `LatentSDE`)."""
    b = inputs.shape[0]
    aux = {}
    x = self.encoder_posembed(self.embedding(inputs))
    if self.depth > 0:
      x, skips = self.multiscale_encoder(x)
      if self.freeze_encoder:
        x = x.detach()
        skips = {k: v.detach() for k, v in skips.items()}
      cfg = self.processor_config
      if cfg.num_samples > 0:
        if not cfg.use_transformer:
          x = x.reshape(b, -1)
        x, aux = self.LatentSDE_0(x, generator, draws)
        if not cfg.use_transformer:
          if x.shape[-1] != int(np.prod(self.tok_shape)):
            raise ValueError(
                f'processor latent_size {x.shape[-1]} must equal the '
                f'flattened encoder output {self.tok_shape} to decode')
          x = x.reshape(x.shape[:2] + self.tok_shape)
        if not self.mean_after_decoder:
          x = x.mean(dim=1)
      if not self.mean_after_decoder:
        x = self.multiscale_decoder(x, skips)
      else:
        # The decoder on every sample (the JAX package's vmap over axis 1):
        # the samples fold into the batch, the skips repeat per sample.
        s = x.shape[1]
        folded = {k: v.repeat_interleave(s, dim=0) for k, v in skips.items()}
        x = self.multiscale_decoder(x.reshape((b * s,) + x.shape[2:]), folded)
        x = x.reshape((b, s) + x.shape[1:]).mean(dim=1)
    x = self.decoded_patches(x)
    for key in AUX_KEYS:
      aux.setdefault(key, torch.zeros(b, dtype=torch.float32,
                                      device=inputs.device))
    return x, aux
