"""Knowledge-distillation losses and the train step (port of
taiwan_whisper_tpu/train/distill.py).

* loss = ce_weight * masked-CE + kl_weight * T^2 * KL(teacher_T || student_T)
  (+ mse_weight * MSE on maximally-spaced decoder hidden states).
* The frozen encoder runs once, under ``torch.no_grad()`` (the JAX package
  stop-gradients the encoder params), through the forward attention kernel
  with no LSE. A trainable encoder runs with autograd, each layer
  checkpointed, through the attention autograd function (forward kernel
  with LSE, backward kernel). Both decoders read the encoder output; the
  teacher runs under ``no_grad``.
* Normalisation is by the batch's non-masked token count. In a
  multi-process run (``parallel.init_distributed``) the ranks form the
  ``(data, model)`` grid of ``parallel.mesh.make_mesh``. The step is data
  parallel over the data group, each model group holding a slice of the
  global batch's rows: it all-reduces the token count over the data group
  before the backward and divides each rank's sums by the global count, so
  the data ranks' losses add up to the global batch's and the SUM
  all-reduce of their gradients (one flat fp32 buffer over the data group)
  is the single-process gradient of the global batch; the logged metrics
  are summed over the data group too. Under tensor parallel
  (``--model_parallel`` M > 1) the ranks of a model group see the same
  rows and hold shards of the student and teacher (``parallel/specs.py``);
  the model's own collectives over the model group
  (``models/whisper.py``) leave every replicated leaf's gradient whole and
  equal on each of them and each split leaf's its shard's, so nothing is
  reduced over the world: that would count every token and gradient M
  times. ``grad_norm`` is the norm of the whole tree (split leaves'
  squares summed over the model group, replicated leaves counted once),
  and the clip scale is equal on every rank.
* Gradients flow only to trainable leaves (the encoder when not frozen,
  the decoder except its positions table): ``requires_grad`` is set on
  exactly those, which is the JAX package's ``zero_frozen``. The global
  norm clip and the AdamW update run in fp32 on the fp32 masters, in place.
* Spans (``utils/profiling.py``): ``train.encode``, ``train.student`` and
  ``train.teacher`` (the three forwards), ``train.backward`` (the
  ``autograd.grad`` call; on a card its kernels launch from autograd's
  device thread, outside the range) and ``train.optimizer`` (the
  data-parallel sums, the clip, AdamW and the in-place apply).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig
from ..models.params import layers_to_supervise, named_leaves
from ..parallel import mesh, specs
from ..utils.profiling import span

LABEL_IGNORE = -100


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """KD hyper-parameters (defaults: beta=0.8 CE, gamma=1.0 KL, T=2)."""

    ce_weight: float = 0.8
    kl_weight: float = 1.0
    temperature: float = 2.0
    mse_weight: float = 0.0
    freeze_encoder: bool = True
    # checkpoint the student decoder's layers in the backward pass (off: the
    # 2-layer student decoder's activations are small)
    remat_student: bool = False


def masked_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid tokens, valid token count); logits [B, U, V]
    fp32, labels [B, U] with LABEL_IGNORE masking."""
    mask = labels != LABEL_IGNORE
    safe = torch.where(mask, labels, 0).long()
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    return nll.sum(), mask.sum()


def kl_divergence(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                  labels: torch.Tensor, temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature-scaled forward KL, masked sum, times T^2."""
    mask = labels != LABEL_IGNORE
    t_prob = torch.softmax(teacher_logits / temperature, dim=-1)
    s_logprob = torch.log_softmax(student_logits / temperature, dim=-1)
    t_logprob = torch.log_softmax(teacher_logits / temperature, dim=-1)
    kl = (t_prob * (t_logprob - s_logprob)).sum(dim=-1)
    kl = torch.where(mask, kl, 0.0)
    return kl.sum() * (temperature ** 2), mask.sum()


def distill_loss(student_params, teacher_params, batch: Dict[str, torch.Tensor],
                 student_config: WhisperConfig, teacher_config: WhisperConfig,
                 dcfg: DistillConfig, policy: DtypePolicy = DtypePolicy(),
                 n_tok: Optional[torch.Tensor] = None):
    """(scalar loss, metrics dict of 0-d tensors) for one batch: ``mel``
    [B, T, n_mels], ``decoder_input_ids`` [B, U], ``labels`` [B, U]
    (-100 on prompt and pad positions). Every term is a sum over the
    batch's label tokens divided by ``n_tok`` (the global count of a
    data-parallel step; the batch's own count when not given)."""
    mel, dec_in, labels = batch["mel"], batch["decoder_input_ids"], batch["labels"]
    with span("train.encode"):
        if dcfg.freeze_encoder:
            with torch.no_grad():
                enc = M.encode(student_params, mel, student_config, policy, remat=False)
        else:
            enc = M.encode(student_params, mel, student_config, policy)

    need_mse = dcfg.mse_weight > 0.0
    # CE-only fine-tuning skips the teacher forward entirely
    need_teacher = dcfg.kl_weight > 0.0 or need_mse
    with span("train.student"):
        s_out = M.decode_train(student_params, enc, dec_in, student_config, policy,
                               output_hidden_states=need_mse, remat=dcfg.remat_student)
    s_logits, s_hidden = s_out if need_mse else (s_out, None)
    t_logits = t_hidden = None
    if need_teacher:
        with span("train.teacher"), torch.no_grad():
            t_out = M.decode_train(teacher_params, enc.detach(), dec_in, teacher_config,
                                   policy, output_hidden_states=need_mse, remat=False)
        t_logits, t_hidden = t_out if need_mse else (t_out, None)

    ce_sum, local_n = masked_cross_entropy(s_logits, labels)
    n_tok = torch.clamp(local_n if n_tok is None else n_tok, min=1)
    ce = ce_sum / n_tok
    loss = dcfg.ce_weight * ce
    metrics = {"ce": ce}
    if need_teacher:
        kl_sum, _ = kl_divergence(t_logits, s_logits, labels, dcfg.temperature)
        kl = kl_sum / n_tok
        loss = loss + dcfg.kl_weight * kl
        metrics["kl"] = kl
    if need_mse:
        # equal-increment teacher layers supervise the student layers,
        # e.g. 32 -> 2 supervises with teacher layers [15, 31]
        idx = layers_to_supervise(student_config.decoder_layers,
                                  teacher_config.decoder_layers)
        t_sel = t_hidden[torch.as_tensor(idx, device=t_hidden.device)]
        mask = (labels != LABEL_IGNORE)[None, :, :, None]
        diff = (s_hidden.float() - t_sel.float()) ** 2
        mse = torch.where(mask, diff, 0.0).sum() / (n_tok * s_hidden.shape[-1])
        loss = loss + dcfg.mse_weight * mse
        metrics["mse"] = mse
    metrics["loss"] = loss
    return loss, metrics


def trainable_paths(params, freeze_encoder: bool):
    """Dotted paths of the leaves that receive gradients: the decoder but
    its positions table, and the encoder when it is not frozen."""
    return [path for path, _ in named_leaves(params)
            if path != "decoder.embed_positions"
            and not (freeze_encoder and path.startswith("encoder."))]


def global_norm(grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (by dotted path), in
    fp32: of the whole tree under tensor parallel, the squares of split
    leaves summed over the model group and replicated leaves counted
    once."""
    split = mesh.model_size() > 1
    sq = {True: [], False: []}
    for path, g in grads.items():
        if g is not None:
            sq[split and specs.split_dim(path) is not None].append(g.float().square().sum())
    total = torch.stack(sq[False]).sum() if sq[False] else 0.0
    if sq[True]:
        total = total + mesh.all_reduce_sum_(torch.stack(sq[True]).sum(), "model")
    return torch.sqrt(total)


def _global_tokens(batch) -> torch.Tensor:
    """The label-token count of the global batch (every data rank's rows)."""
    return mesh.all_reduce_sum_((batch["labels"] != LABEL_IGNORE).sum(), "data")


def _sum_metrics(metrics):
    """Each metric summed over the data group (one all-reduce)."""
    keys = list(metrics)
    total = mesh.all_reduce_sum_(torch.stack([metrics[k] for k in keys]), "data")
    return dict(zip(keys, total.unbind()))


def _sum_grads(grads):
    """The gradients summed over the data group through one flat fp32
    buffer."""
    present = [g for g in grads if g is not None]
    flat = mesh.all_reduce_sum_(torch.cat([g.reshape(-1) for g in present]), "data")
    summed = iter(torch.split(flat, [g.numel() for g in present]))
    return [None if g is None else next(summed).view_as(g) for g in grads]


def make_train_step(student_config: WhisperConfig, teacher_config: WhisperConfig,
                    dcfg: DistillConfig, optimizer, policy: DtypePolicy = DtypePolicy(),
                    max_grad_norm: Optional[float] = 1.0):
    """The train step ``(student_params, opt_state, teacher_params, batch)
    -> (student_params, opt_state, metrics)``. The student's fp32 leaves
    are updated in place and returned. Made in a multi-process run,
    ``batch`` is this rank's slice of the global batch, and the step is the
    global batch's (see the module docstring)."""
    data_parallel = mesh.initialized()

    def train_step(student_params, opt_state, teacher_params, batch):
        leaves = dict(named_leaves(student_params))
        paths = trainable_paths(student_params, dcfg.freeze_encoder)
        for path in paths:
            leaves[path].requires_grad_(True)
        n_tok = _global_tokens(batch) if data_parallel else None
        loss, metrics = distill_loss(student_params, teacher_params, batch, student_config,
                                     teacher_config, dcfg, policy, n_tok)
        with span("train.backward"):
            got = torch.autograd.grad(loss, [leaves[p] for p in paths], allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        with span("train.optimizer"):
            if data_parallel:
                got, metrics = _sum_grads(got), _sum_metrics(metrics)
            grads = dict(zip(paths, got))
            if max_grad_norm is not None:
                gnorm = global_norm(grads)
                scale = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                grads = {p: None if g is None else g * scale for p, g in grads.items()}
                metrics["grad_norm"] = gnorm
            updates, opt_state = optimizer.update(grads, opt_state, leaves)
            with torch.no_grad():
                for path, u in updates.items():
                    if u is not None:
                        leaves[path].add_(u.to(leaves[path].dtype))
        return student_params, opt_state, metrics

    return train_step


def make_eval_step(student_config: WhisperConfig, teacher_config: WhisperConfig,
                   dcfg: DistillConfig, policy: DtypePolicy = DtypePolicy()):
    """Loss-only eval step: metrics of one batch, no gradients (of the
    global batch in a multi-process run, as in ``make_train_step``)."""
    data_parallel = mesh.initialized()

    def eval_step(student_params, teacher_params, batch):
        with torch.no_grad():
            n_tok = _global_tokens(batch) if data_parallel else None
            _, metrics = distill_loss(student_params, teacher_params, batch, student_config,
                                      teacher_config, dcfg, policy, n_tok)
            return _sum_metrics(metrics) if data_parallel else metrics

    return eval_step
