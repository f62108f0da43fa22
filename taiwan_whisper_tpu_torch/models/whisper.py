"""Whisper encoder-decoder in PyTorch (port of
taiwan_whisper_tpu/models/whisper.py): inference and training.

Plain functions over the weights dict of models/params.py. Every matmul
weight, conv weight and embedding is cast to the compute dtype where it
is used, inside the autograd graph, as the JAX package's ``_dense`` does:
training keeps fp32 masters and their gradients arrive in fp32. For
inference ``prepare_params`` casts once at load, and the casts are no-ops.
The JAX package's layouts are kept at the public functions: encoder q/k/v
``[B, S, H, Dh]``, the cross K/V time-minor ``[L, B, H, Dh, T]`` with
scales ``[L, B, H, Dh, 1]``, the self cache ``[L, B, H, Dh, S]``; the cross
K/V and the cache are views of storage whose last axis is padded so every
row starts on 128 bytes (``ops/decode_attention.py::time_minor_zeros``), as
the decode kernels' 16-byte copies need. On CUDA
tensors encoder self-attention (forward, and backward when the encoder
trains), cross-attention (decode steps and prefill) and cached
self-attention go through the port's CUDA kernels; on CPU tensors through
their plain versions. ``decode_train``'s attention is plain ``torch``
matmuls, as the JAX package leaves it to XLA, except where the decoder
runs on a CUDA bf16 tensor with no gradient recorded and no
``attention_mask`` (the frozen teacher of distillation, evaluation
losses): there its causal self-attention and its cross-attention take the
hand-written kernel of ``ops/attention.py::decoder_attention``.

Differences from the JAX package, by design:
* the KV cache is updated IN PLACE: each decode step writes its k/v at
  position ``index`` of layer l right after layer l's attention (JAX
  commits all layers after the layer scan; position ``index`` is masked
  during the step either way), and ``prefill`` fills ``[0, P)`` in place;
* ``remat`` checkpoints each layer with ``torch.utils.checkpoint`` only
  while autograd records (under ``no_grad`` it would buy nothing);
* int4 cross K/V is stored packed two positions a byte (uint8; PyTorch has
  no int4 dtype), and ``QuantCrossKV.length`` carries the logical length;
* ``extend`` writes its P tokens' K/V into the cache in place, as the
  other decoder entry points do.

Tensor parallel (``parallel/specs.py``): every function takes one model
rank's shard of the weights as it takes the full tree. A layer whose q
projection holds fewer rows than the model width is split, and runs as
Megatron's pair of collectives over the model group of
``parallel/mesh.py``: the input of the column-split projections (the LN
output feeding q/k/v or ``fc1``, and the encoder output feeding every
cross k/v, once each) goes through ``_ToModelGroup`` (identity; the
backward sums the gradient over the group), and the output of a row-split
``out``/``fc2`` through ``_FromModelGroup`` (the sum over the group; the
replicated bias added after it, in ``_row_dense``). Head counts come from the weights' rows,
so the attention kernels and the caches run on the rank's local heads,
and the logits (``embed_tokens`` replicated) come out whole on every rank.
The JAX model turns its Pallas decode kernels off under a model axis
(``pallas_call`` does not auto-partition); here each rank calls the CUDA
decode kernels on its whole local heads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_plain, decoder_attention, encoder_attention
from ..ops.decode_attention import (cross_attention, cross_attention_int8_dots, pack_int4,
                                    self_attention, time_minor_zeros)
from ..parallel import mesh
from .config import DtypePolicy, WhisperConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x W^T + b with W [d_out, d_in] cast to x's (the compute) dtype."""
    b = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if b is None else b.to(x.dtype))


def _layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 regardless of the compute dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[B, S, H * Dh] -> [B, S, H, Dh]: H the heads the projection holds (a
    model rank's local heads under tensor parallel)."""
    b, s, d = x.shape
    return x.view(b, s, d // head_dim, head_dim)


def _head_dim(config: WhisperConfig, decoder: bool = False) -> int:
    heads = config.decoder_attention_heads if decoder else config.encoder_attention_heads
    return config.d_model // heads


def _local_heads(params: Params, config: WhisperConfig) -> int:
    """The decoder heads ``params`` hold: all of them, or a model rank's
    share of a tensor-parallel shard (the self cache's head axis)."""
    rows = params["decoder"]["layers"][0]["self_attn"]["q"]["weight"].shape[0]
    return rows // _head_dim(config, decoder=True)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


class _MixedHead(torch.autograd.Function):
    """x [N, d] (bf16) against the table [V, d] cast to x's dtype: bf16
    operands, fp32 accumulation and fp32 logits, on the card. The backward
    rounds the fp32 gradient to bf16 for its two products (fp32
    accumulation again) and hands the table an fp32 gradient."""

    @staticmethod
    def forward(ctx, x, table):
        w = table.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.table_dtype = table.dtype
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(x.dtype)
        gx = torch.mm(gb, w) if ctx.needs_input_grad[0] else None
        gw = (torch.mm(gb.t(), x, out_dtype=torch.float32).to(ctx.table_dtype)
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def _lm_head(embed_tokens: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: compute-dtype operands, fp32 accumulation AND fp32
    logits — a bf16 product rounded to bf16 would create ties that the
    greedy rules break toward text, flipping tokens."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if x.dtype != torch.float32 and x.is_cuda:
        y = _MixedHead.apply(x, embed_tokens)
    else:
        # bf16 x bf16 products are exact in fp32, so upcasting first computes
        # the same function (the CPU has no mixed-dtype product)
        y = x.float() @ embed_tokens.to(x.dtype).float().t()
    return y.view(*lead, -1)


def _conv1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1-D conv over [B, T, Cin] with SAME-1 padding -> [B, T', Cout]."""
    y = F.conv1d(x.transpose(1, 2), p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                 stride=stride, padding=1)
    return y.transpose(1, 2)


class _ToModelGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (Megatron's f, at the input of column-split projections)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum_(g.clone(memory_format=torch.contiguous_format), "model")


class _FromModelGroup(torch.autograd.Function):
    """The sum over the model group forward, in place; identity backward
    (Megatron's g, at the output of row-split projections)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mark_dirty(x)
        return mesh.all_reduce_sum_(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g


def _is_split(lp: Params, d_model: int) -> bool:
    """Whether layer ``lp`` holds a model rank's shard: its self-attention
    q projection has fewer rows than the model width. Raises on a shard
    outside a model group, whose sums would be skipped."""
    split = lp["self_attn"]["q"]["weight"].shape[0] != d_model
    if split and mesh.model_size() == 1:
        raise RuntimeError("tensor-parallel weights need parallel.mesh.make_mesh(model=M)")
    return split


def _to_model_group(x: torch.Tensor, split: bool) -> torch.Tensor:
    return _ToModelGroup.apply(x) if split else x


def _row_dense(p: Params, x: torch.Tensor, split: bool) -> torch.Tensor:
    """``_dense`` of a row-split projection (out, fc2): on a shard, the
    local product summed over the model group, then the bias."""
    if not split:
        return _dense(p, x)
    y = _FromModelGroup.apply(F.linear(x, p["weight"].to(x.dtype)))
    return y + p["bias"].to(x.dtype)


def _mlp(lp: Params, h: torch.Tensor, split: bool) -> torch.Tensor:
    return _row_dense(lp["fc2"], _gelu(_dense(lp["fc1"], _to_model_group(h, split))), split)


def _run_layer(fn, lp: Params, x: torch.Tensor, *args, remat: bool) -> torch.Tensor:
    """``fn(lp, x, *args)``, checkpointed when ``remat`` and autograd is
    recording (``jax.checkpoint`` on the JAX package's scanned body)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, lp, x, *args, use_reentrant=False)
    return fn(lp, x, *args)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _encoder_layer(lp: Params, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    split = _is_split(lp, x.shape[-1])
    h = _to_model_group(_layer_norm(lp["self_attn_ln"], x), split)
    a = lp["self_attn"]
    q = _split_heads(_dense(a["q"], h), head_dim)
    k = _split_heads(_dense(a["k"], h), head_dim)
    v = _split_heads(_dense(a["v"], h), head_dim)
    x = x + _row_dense(a["out"], _merge_heads(encoder_attention(q, k, v)), split)
    return x + _mlp(lp, _layer_norm(lp["final_ln"], x), split)


def encode(params: Params, mel: torch.Tensor, config: WhisperConfig,
           policy: DtypePolicy = DtypePolicy(), *, remat: bool = True) -> torch.Tensor:
    """Encoder forward: conv stem -> +sinusoid positions -> N layers -> LN.
    mel [B, n_frames, num_mel_bins] -> [B, max_source_positions, d_model]
    in the compute dtype. The positions table never trains (its gradient
    stops here); ``remat`` checkpoints each layer while autograd records."""
    p = params["encoder"]
    dtype = policy.compute_dtype
    x = _gelu(_conv1d(p["conv1"], mel.to(dtype), stride=1))
    x = _gelu(_conv1d(p["conv2"], x, stride=2))
    x = x + p["embed_positions"].detach().to(dtype)
    for lp in p["layers"]:
        x = _run_layer(_encoder_layer, lp, x, _head_dim(config), remat=remat)
    return _layer_norm(p["ln_post"], x).to(dtype)


def _decoder_kernel_applies(q: torch.Tensor, plain_tril: bool) -> bool:
    """Whether ``_decoder_train_layer`` takes ``decoder_attention``: q a
    CUDA bf16 tensor, no gradient recorded, and the self-attention mask the
    plain causal tril (``decode_train`` got no ``attention_mask``)."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16 and plain_tril
            and not torch.is_grad_enabled())


def _decoder_train_layer(lp: Params, x: torch.Tensor, enc: torch.Tensor,
                         causal: torch.Tensor, head_dim: int, plain_tril: bool) -> torch.Tensor:
    """One decoder layer over the whole sequence; ``enc`` has been through
    ``_to_model_group`` already when the layer is split. ``plain_tril``:
    ``causal`` is the plain tril, so the kernel may stand in for it."""
    split = _is_split(lp, x.shape[-1])
    h = _to_model_group(_layer_norm(lp["self_attn_ln"], x), split)
    a = lp["self_attn"]
    q = _split_heads(_dense(a["q"], h), head_dim)
    k = _split_heads(_dense(a["k"], h), head_dim)
    v = _split_heads(_dense(a["v"], h), head_dim)
    kernel = _decoder_kernel_applies(q, plain_tril)
    att = decoder_attention(q, k, v, causal=True) if kernel else attention_plain(q, k, v, causal)
    x = x + _row_dense(a["out"], _merge_heads(att), split)
    h = _to_model_group(_layer_norm(lp["cross_attn_ln"], x), split)
    c = lp["cross_attn"]
    q = _split_heads(_dense(c["q"], h), head_dim)
    k = _split_heads(_dense(c["k"], enc), head_dim)
    v = _split_heads(_dense(c["v"], enc), head_dim)
    att = decoder_attention(q, k, v, causal=False) if kernel else attention_plain(q, k, v)
    x = x + _row_dense(c["out"], _merge_heads(att), split)
    return x + _mlp(lp, _layer_norm(lp["final_ln"], x), split)


def decode_train(params: Params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 config: WhisperConfig, policy: DtypePolicy = DtypePolicy(), *,
                 attention_mask: Optional[torch.Tensor] = None,
                 output_hidden_states: bool = False, remat: bool = True):
    """Full-sequence (teacher-forcing) decoder forward -> fp32 logits
    [B, U, vocab]: causal self-attention, cross-attention over ``enc_out``.
    ``attention_mask`` ([B, U] bool, True = keep) masks keys of left-padded
    prompts. With ``output_hidden_states`` returns (logits, hidden
    [L, B, U, d]), hidden[l] the output of decoder layer l."""
    p = params["decoder"]
    dtype = policy.compute_dtype
    u = tokens.shape[1]
    x = F.embedding(tokens, p["embed_tokens"]).to(dtype) + p["embed_positions"][:u].to(dtype)
    causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=tokens.device))[None, None]
    if attention_mask is not None:
        causal = causal & attention_mask[:, None, None, :]
    enc = enc_out.to(dtype)
    if p["layers"]:
        # one backward sum for every layer's cross k/v of a split decoder
        enc = _to_model_group(enc, _is_split(p["layers"][0], config.d_model))
    hidden = []
    for lp in p["layers"]:
        x = _run_layer(_decoder_train_layer, lp, x, enc, causal,
                       _head_dim(config, decoder=True), attention_mask is None, remat=remat)
        if output_hidden_states:
            hidden.append(x)
    logits = _lm_head(p["embed_tokens"], _layer_norm(p["ln_post"], x))
    if output_hidden_states:
        return logits, torch.stack(hidden)
    return logits


def forward(params: Params, mel: torch.Tensor, tokens: torch.Tensor, config: WhisperConfig,
            policy: DtypePolicy = DtypePolicy()) -> torch.Tensor:
    """encoder + teacher-forcing decoder -> fp32 logits [B, U, vocab]."""
    return decode_train(params, encode(params, mel, config, policy), tokens, config, policy)


# ---------------------------------------------------------------------------
# decoder: incremental decode with the time-minor KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Self-attention cache of all decoder layers, [L, B, H, Dh, S] each
    (views of row-padded storage), updated in place."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[-1]


def init_cache(params: Params, config: WhisperConfig, batch: int,
               max_len: Optional[int] = None, dtype=torch.bfloat16, device="cpu") -> KVCache:
    """An empty cache for the decoder heads ``params`` hold: all of them,
    or under tensor parallel a model rank's share."""
    s = max_len or config.max_target_positions
    shape = (config.decoder_layers, batch, _local_heads(params, config),
             _head_dim(config, decoder=True), s)
    return KVCache(k=time_minor_zeros(shape, dtype, device),
                   v=time_minor_zeros(shape, dtype, device))


@dataclasses.dataclass
class QuantCrossKV:
    """Quantized cross-attention K/V with per-(layer, batch, head, channel)
    scales; the K scale folds into q and the V scale into the output."""

    k_q: torch.Tensor  # [L, B, H, Dh, T] int8 / float8_e4m3fn (time-minor);
    # int4: uint8 [L, B, H, Dh, ceil(T / 2)], two positions a byte
    k_scale: torch.Tensor  # [L, B, H, Dh, 1] fp32
    v_q: torch.Tensor
    v_scale: torch.Tensor
    length: Optional[int] = None  # T of packed int4 storage


CrossKV = Union[Tuple[torch.Tensor, torch.Tensor], QuantCrossKV]


def _quantize_kv_slice(x: torch.Tensor, bits):
    """Symmetric per-channel quantization of a time-minor K or V tensor
    (reduction over the minor time axis). int4 comes back packed two
    positions a byte (``ops.decode_attention.pack_int4``)."""
    if bits == 8 or bits is True:
        qmax, store = 127.0, torch.int8
    elif bits == 4:
        qmax, store = 7.0, torch.int8
    elif bits == "fp8":
        qmax, store = 448.0, torch.float8_e4m3fn
    else:
        raise ValueError(f"bits must be 8, 4 or 'fp8', got {bits!r}")
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = m / qmax + 1e-12
    xs = xf / scale
    if bits != "fp8":  # fp8's cast rounds natively; ints need round+clip
        xs = torch.clamp(torch.round(xs), -qmax, qmax)
    xs = xs.to(store)
    return (pack_int4(xs) if bits == 4 else xs), scale


def precompute_cross_kv(params: Params, enc_out: torch.Tensor, config: WhisperConfig,
                        policy: DtypePolicy = DtypePolicy(), *, quantize=0) -> CrossKV:
    """Cross-attention K/V of all layers, time-minor [L, B, H, Dh, T] in
    row-padded storage (a QuantCrossKV when ``quantize`` is 8/True, 4 or
    "fp8"), written layer by layer so the fp32 transient stays one layer's
    size."""
    dtype = policy.compute_dtype
    head_dim = _head_dim(config, decoder=True)
    layers = params["decoder"]["layers"]
    enc = enc_out.to(dtype)
    ks = vs = None
    k_scales, v_scales = [], []
    for i, lp in enumerate(layers):
        a = lp["cross_attn"]
        # [B, T, H, Dh] -> [B, H, Dh, T]
        k = _split_heads(_dense(a["k"], enc), head_dim).permute(0, 2, 3, 1)
        v = _split_heads(_dense(a["v"], enc), head_dim).permute(0, 2, 3, 1)
        if quantize:
            (k, k_scale), (v, v_scale) = _quantize_kv_slice(k, quantize), \
                _quantize_kv_slice(v, quantize)
            k_scales.append(k_scale)
            v_scales.append(v_scale)
        if ks is None:
            ks = time_minor_zeros((len(layers), *k.shape), k.dtype, k.device)
            vs = time_minor_zeros((len(layers), *v.shape), v.dtype, v.device)
        ks[i] = k
        vs[i] = v
    if quantize:
        return QuantCrossKV(k_q=ks, k_scale=torch.stack(k_scales), v_q=vs,
                            v_scale=torch.stack(v_scales),
                            length=enc.shape[1] if quantize == 4 else None)
    return ks, vs


def _cross_layer(cross_kv: CrossKV, layer: int):
    """One layer's (k, k scale, v, v scale, int4 length): the scales are
    None for unquantized K/V, the length None but for packed int4."""
    if isinstance(cross_kv, QuantCrossKV):
        return (cross_kv.k_q[layer], cross_kv.k_scale[layer],
                cross_kv.v_q[layer], cross_kv.v_scale[layer], cross_kv.length)
    return cross_kv[0][layer], None, cross_kv[1][layer], None, None


def _cross_attention(q: torch.Tensor, cross_slice, dtype, beams: int = 1,
                     int8_dots: bool = False) -> torch.Tensor:
    """q [B, Sq, H, Dh] against one layer's cross K/V [B, H, Dh, T]
    (``_cross_layer``'s tuple, plain or quantized). 1/sqrt(d) and the K scale fold into q in fp32
    before one cast to the compute dtype; the V scale multiplies the fp32
    attention output. ``beams``: q arrives beam-flat [B*K, Sq, H, Dh]
    against K/V stored once per item, and the beams fold into the query
    axis, [B, K*Sq, H, Dh], so every beam reads the same K/V.
    ``int8_dots`` on int8 storage: the "8x8" route, the folded fp32 q
    straight into the kernel's int8 x int8 variant."""
    if beams > 1:
        bk, sq, nh, dh = q.shape
        q = q.reshape(bk // beams, beams * sq, nh, dh)
    scale = q.shape[-1] ** -0.5
    kq, ks, vq, vs, t = cross_slice
    if ks is not None:  # quantized
        qf = q.float() * scale * ks.permute(0, 3, 1, 2)
        if int8_dots and kq.dtype == torch.int8:
            att = cross_attention_int8_dots(qf, kq, vq)
        else:
            att = cross_attention(qf.to(dtype), kq, vq, t)
        att = att * vs.permute(0, 3, 1, 2)
    else:
        att = cross_attention((q * scale).to(dtype), kq, vq)  # fp32 [B, Sq, H, Dh]
    if beams > 1:
        att = att.reshape(bk, sq, nh, dh)
    return att.to(dtype)


def _cached_self_attn(lp: Params, h: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, index: int, head_dim: int, dtype,
                      valid_from: Optional[torch.Tensor] = None,
                      split: bool = False) -> torch.Tensor:
    """One-token self-attention against the cache [B, H, Dh, S]: the
    current token is attended to directly (cache position ``index`` stays
    masked), then its k/v are written into the cache at ``index`` in place.
    h: [B, 1, d] -> [B, 1, d]."""
    b = h.shape[0]
    q = _dense(lp["q"], h).view(b, -1, head_dim)  # [B, H, Dh]
    k_t = _dense(lp["k"], h).view(b, -1, head_dim).to(cache_k.dtype)
    v_t = _dense(lp["v"], h).view(b, -1, head_dim).to(cache_v.dtype)
    qh = q * (q.shape[-1] ** -0.5)
    out = self_attention(qh, cache_k, cache_v, k_t, v_t, index, valid_from)
    cache_k[..., index] = k_t
    cache_v[..., index] = v_t
    return _row_dense(lp["out"], out.to(dtype).reshape(b, 1, -1), split)


def decode_step(params: Params, cross_kv: CrossKV, cache: KVCache,
                token: torch.Tensor, index: int, config: WhisperConfig,
                policy: DtypePolicy = DtypePolicy(), *,
                valid_from: Optional[torch.Tensor] = None, beams: int = 1,
                int8_dots: bool = False) -> torch.Tensor:
    """One decoder step for ``token`` ([B] or [B, 1]) at position
    ``index``; updates ``cache`` in place and returns fp32 logits [B, vocab].
    ``beams``: rows per cross-K/V item (beam search: B = items x beams).
    ``int8_dots``: the "8x8" cross attention over int8 cross K/V."""
    p = params["decoder"]
    dtype = policy.compute_dtype
    head_dim = _head_dim(config, decoder=True)
    if token.dim() == 1:
        token = token[:, None]
    x = p["embed_tokens"][token] + p["embed_positions"][index]  # [B, 1, d]
    for i, lp in enumerate(p["layers"]):
        split = _is_split(lp, config.d_model)
        h = _layer_norm(lp["self_attn_ln"], x)
        x = x + _cached_self_attn(lp["self_attn"], h, cache.k[i], cache.v[i], index,
                                  head_dim, dtype, valid_from, split)
        h = _layer_norm(lp["cross_attn_ln"], x)
        q = _split_heads(_dense(lp["cross_attn"]["q"], h), head_dim)
        att = _cross_attention(q, _cross_layer(cross_kv, i), dtype, beams, int8_dots)
        x = x + _row_dense(lp["cross_attn"]["out"], _merge_heads(att), split)
        x = x + _mlp(lp, _layer_norm(lp["final_ln"], x), split)
    x = _layer_norm(p["ln_post"], x)
    return _lm_head(p["embed_tokens"], x[:, 0])


def prefill(params: Params, cross_kv: CrossKV, cache: KVCache, tokens: torch.Tensor,
            config: WhisperConfig, policy: DtypePolicy = DtypePolicy(), *,
            valid_from: Optional[torch.Tensor] = None,
            aux_index: int = 0, beams: int = 1,
            int8_dots: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the prompt [B, P] through the decoder in one pass, filling
    cache[..., 0:P] in place. Returns (fp32 logits at the last prompt
    position [B, vocab], fp32 logits at ``aux_index`` [B, vocab] — the
    no-speech probe at <|startoftranscript|>). ``beams`` and ``int8_dots``
    as in ``decode_step``: the cross kernel then takes K*P query rows an
    item."""
    p = params["decoder"]
    dtype = policy.compute_dtype
    head_dim = _head_dim(config, decoder=True)
    b, pl_len = tokens.shape
    x = p["embed_tokens"][tokens] + p["embed_positions"][:pl_len]
    mask = torch.tril(torch.ones(pl_len, pl_len, dtype=torch.bool, device=tokens.device))
    mask = mask[None, None]
    if valid_from is not None:
        keep = torch.arange(pl_len, device=tokens.device)[None, :] >= valid_from[:, None]
        mask = mask & keep[:, None, None, :]
    for i, lp in enumerate(p["layers"]):
        split = _is_split(lp, config.d_model)
        h = _layer_norm(lp["self_attn_ln"], x)
        a = lp["self_attn"]
        q = _split_heads(_dense(a["q"], h), head_dim)
        k = _split_heads(_dense(a["k"], h), head_dim)
        v = _split_heads(_dense(a["v"], h), head_dim)
        x = x + _row_dense(a["out"], _merge_heads(attention_plain(q, k, v, mask)), split)
        cache.k[i, ..., :pl_len] = k.permute(0, 2, 3, 1)
        cache.v[i, ..., :pl_len] = v.permute(0, 2, 3, 1)
        h = _layer_norm(lp["cross_attn_ln"], x)
        q = _split_heads(_dense(lp["cross_attn"]["q"], h), head_dim)
        att = _cross_attention(q, _cross_layer(cross_kv, i), dtype, beams, int8_dots)
        x = x + _row_dense(lp["cross_attn"]["out"], _merge_heads(att), split)
        x = x + _mlp(lp, _layer_norm(lp["final_ln"], x), split)
    x = _layer_norm(p["ln_post"], x)
    both = _lm_head(p["embed_tokens"], torch.stack([x[:, -1], x[:, aux_index]], dim=1))
    return both[:, 0], both[:, 1]


def extend(params: Params, cross_kv: CrossKV, cache: KVCache, tokens: torch.Tensor,
           offset: int, config: WhisperConfig, policy: DtypePolicy = DtypePolicy(), *,
           beams: int = 1, int8_dots: bool = False) -> torch.Tensor:
    """Multi-token decode: P ``tokens`` [B, P] at positions offset ..
    offset + P - 1 against a cache valid below ``offset``, in one pass; the
    verification step of speculative decoding. Their K/V go into
    cache[..., offset:offset + P] in place; query i sees the cache keys at
    positions <= offset + i (plain ``torch`` attention over the whole cache,
    masked, as the JAX model's einsums do); the cross kernel takes the P
    rows. ``beams`` and ``int8_dots`` as in ``decode_step``. Returns fp32
    logits [B, P, vocab]."""
    p = params["decoder"]
    dtype = policy.compute_dtype
    head_dim = _head_dim(config, decoder=True)
    plen = tokens.shape[1]
    s = cache.max_len
    if not 0 <= offset <= s - plen:
        raise ValueError(f"extend writes positions {offset}..{offset + plen - 1} of a "
                         f"{s}-position cache")
    x = p["embed_tokens"][tokens] + p["embed_positions"][offset:offset + plen]
    key_pos = torch.arange(s, device=tokens.device)
    q_pos = offset + torch.arange(plen, device=tokens.device)
    mask = (key_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, P, S]
    for i, lp in enumerate(p["layers"]):
        split = _is_split(lp, config.d_model)
        h = _layer_norm(lp["self_attn_ln"], x)
        a = lp["self_attn"]
        q = _split_heads(_dense(a["q"], h), head_dim)
        k = _split_heads(_dense(a["k"], h), head_dim)
        v = _split_heads(_dense(a["v"], h), head_dim)
        ck, cv = cache.k[i], cache.v[i]
        ck[..., offset:offset + plen] = k.permute(0, 2, 3, 1)
        cv[..., offset:offset + plen] = v.permute(0, 2, 3, 1)
        att = attention_plain(q, ck.permute(0, 3, 1, 2), cv.permute(0, 3, 1, 2), mask)
        x = x + _row_dense(a["out"], _merge_heads(att), split)
        h = _layer_norm(lp["cross_attn_ln"], x)
        q = _split_heads(_dense(lp["cross_attn"]["q"], h), head_dim)
        att = _cross_attention(q, _cross_layer(cross_kv, i), dtype, beams, int8_dots)
        x = x + _row_dense(lp["cross_attn"]["out"], _merge_heads(att), split)
        x = x + _mlp(lp, _layer_norm(lp["final_ln"], x), split)
    return _lm_head(p["embed_tokens"], _layer_norm(p["ln_post"], x))
