"""The comparison that decides ``correct`` in the training cells.

Set-up drives the port's train step through its first three steps, the
same object that the window then runs. From them the window driver keeps the
host batches the data layer fed them, the three losses, the trainable
leaves before step 1 and after step 3, and the AdamW first moments after
step 1 (the clipped gradient that the optimizer got is mu / (1 - beta1)).
The reference works the rest out again, in float32 with TF32 off:

* ``batch_rows_differing``: its own batches from the manifest and the
  seed (``reference/data.py``) against the rows the port trained on.
  Exact: limit 0.
* ``init_max_abs``: the student it cuts from the teacher (the zh
  embedding mixed with en's, decoder layers 0 and L-1) or loads, against
  the port's trainable leaves before step 1. Exact: limit 0.
* ``loss_rel_gap``: the worst |loss - reference| / |reference| of the
  first ``limits.loss_steps`` steps (of three). The loss is 0.8 CE + 1.0
  T^2 KL(teacher_T || student_T) at T = 2 (distillation) or CE
  (fine-tuning), each a masked sum over the batch's label tokens over
  their count.
* ``grad_norm_gap``: over the trainable leaves, the worst
  | |g| - |g_ref| | of step 1's clipped gradient, over the larger of the
  reference leaf's norm and the median leaf's.
* ``change_norm_gap``: the same of each leaf's change over the three
  steps, leaving out leaves whose step-1 reference gradient is under a
  thousandth of the median leaf's (they move by rounding alone).

The global norm is clipped to 1 and AdamW (b1 0.9, b2 0.999, eps 1e-8, no
decay) takes the learning rate of a linear warmup from 0. The control is
the same reference at fp8 (``model.Precision``) in the port's place.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..harness import Check
from . import data as D
from .model import Precision, Whisper, encode_blocks, log_mel, strict_fp32

B1, B2, EPS = 0.9, 0.999, 1e-8
ROWS = 8  # rows per block of the student's forward and backward
EN, ZH = 50259, 50260


def hf_name(path: str) -> str:
    """The port's dotted leaf path -> the HF tensor name."""
    parts = path.split(".")
    ren = {"self_attn_ln": "self_attn_layer_norm", "cross_attn_ln": "encoder_attn_layer_norm",
           "final_ln": "final_layer_norm", "cross_attn": "encoder_attn", "ln_post": "layer_norm",
           "q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj"}
    out = [ren.get(p, p) for p in parts]
    name = ".".join(out)
    if name in ("decoder.embed_tokens", "decoder.embed_positions",
                "encoder.embed_positions"):
        name += ".weight"
    return name


def float_weights(sd: Dict[str, torch.Tensor], mix: bool) -> Dict[str, torch.Tensor]:
    """float32 weights by HF name; ``mix``: the zh embedding is the mean of
    zh's and en's (the K2D trick the distillation applies)."""
    w = {k: v.float() for k, v in sd.items()}
    if mix:
        emb = w["decoder.embed_tokens.weight"].clone()
        emb[ZH] = 0.5 * emb[ZH] + 0.5 * emb[EN]
        w["decoder.embed_tokens.weight"] = emb
    return w


def cut_student(w: Dict[str, torch.Tensor], teacher_cfg: dict,
                student_cfg: dict) -> Dict[str, torch.Tensor]:
    """The student cut from the teacher: its decoder layers at
    ``linspace(0, L-1, n)`` (the last forced to L-1), the rest shared."""
    n, big = student_cfg["decoder_layers"], teacher_cfg["decoder_layers"]
    idx = np.linspace(0, big - 1, n).astype(int).tolist()
    idx[-1] = big - 1
    out = {k: v for k, v in w.items() if not k.startswith("decoder.layers.")}
    for j, i in enumerate(idx):
        pre = f"decoder.layers.{i}."
        for k, v in w.items():
            if k.startswith(pre):
                out[f"decoder.layers.{j}." + k[len(pre):]] = v
    return out


def trainable(names) -> List[str]:
    return sorted(k for k in names if k.startswith("decoder.")
                  and k != "decoder.embed_positions.weight")


def _losses(s_logits, t_logits, labels, n_tok, dist: dict):
    mask = labels != D.IGNORE
    safe = torch.where(mask, labels, 0)
    ce = -(torch.log_softmax(s_logits, -1).gather(-1, safe[..., None])[..., 0])
    ce = torch.where(mask, ce, 0.0).sum() / n_tok
    loss = dist["ce_weight"] * ce
    if t_logits is not None:
        t = dist["temperature"]
        tp = torch.softmax(t_logits / t, -1)
        kl = (tp * (torch.log_softmax(t_logits / t, -1) - torch.log_softmax(s_logits / t, -1))
              ).sum(-1)
        loss = loss + dist["kl_weight"] * torch.where(mask, kl, 0.0).sum() * t * t / n_tok
    return loss


def reference_steps(sd, student_cfg, teacher_cfg, batches, *, dist: dict, opt: dict,
                    mix: bool, precision: Precision, device):
    """Three steps of the reference: (losses, step-1 clipped grads, init,
    params after the steps), leaves by HF name."""
    full = float_weights(sd, mix)
    w = cut_student(full, teacher_cfg, student_cfg) if teacher_cfg is not None else full
    names = trainable(w)
    init = {k: w[k] for k in names}
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    base = {k: v for k, v in w.items() if k not in params}
    student = Whisper({**base, **params}, student_cfg, precision)
    teacher = None
    if teacher_cfg is not None:
        teacher = Whisper({k: v for k, v in full.items() if not k.startswith("encoder.")},
                          teacher_cfg, precision)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, g1 = [], None
    for count, b in enumerate(batches):
        audio = torch.from_numpy(b["audio"]).to(device)
        dec_in = torch.from_numpy(np.asarray(b["decoder_input_ids"], np.int64)).to(device)
        labels = torch.from_numpy(np.asarray(b["labels"], np.int64)).to(device)
        n_tok = (labels != D.IGNORE).sum().clamp(min=1)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r in range(0, audio.shape[0], ROWS):
            with torch.no_grad():
                enc = encode_blocks(student, log_mel(audio[r:r + ROWS], student_cfg["num_mel_bins"]))
                t_logits = teacher.decode(enc, dec_in[r:r + ROWS]) if teacher else None
            s_logits = student.decode(enc, dec_in[r:r + ROWS])
            loss = _losses(s_logits, t_logits, labels[r:r + ROWS], n_tok, dist)
            got = torch.autograd.grad(loss, [params[k] for k in names])
            for k, g in zip(names, got):
                grads[k] += g
            total += float(loss.detach())
            del s_logits, t_logits, loss, got
        losses.append(total)
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, 1.0 / (float(gnorm) + 1e-6))
        grads = {k: g * scale for k, g in grads.items()}
        if count == 0:
            g1 = {k: g.clone() for k, g in grads.items()}
        warm = opt["warmup_steps"]
        lr = opt["learning_rate"] * min(count, warm) / warm if count < warm else opt["learning_rate"]
        c = count + 1
        with torch.no_grad():
            for k in names:
                mu[k] = (1 - B1) * grads[k] + B1 * mu[k]
                nu[k] = (1 - B2) * grads[k] * grads[k] + B2 * nu[k]
                u = (mu[k] / (1 - B1 ** c)) / (torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                params[k].add_(-lr * u)
    return losses, g1, init, {k: v.detach() for k, v in params.items()}


def _worst_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                    keys) -> float:
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return max((abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
                for k in keys), default=float("inf"))


def check(*, sd, student_cfg: dict, teacher_cfg: Optional[dict], manifest: str,
          prog: dict, data: dict, dist: dict, opt: dict, mix: bool, limits: dict, device,
          control: bool = False) -> List[Check]:
    """``prog``: {"batches": 3 host batches, "losses": [3], "mu1", "p0",
    "p3": {port path: tensor}}."""
    strict_fp32()
    ref_b = D.batches(manifest, seed=data["seed"], batch_size=data["batch_size"], n=3,
                      ts_prob=data["timestamp_probability"],
                      prev_prob=data["condition_on_prev_probability"])
    differ = 0
    for rb, pb in zip(ref_b, prog["batches"]):
        for i in range(len(rb["labels"])):
            same = (np.array_equal(rb["audio"][i], pb["audio"][i])
                    and np.array_equal(rb["decoder_input_ids"][i], pb["decoder_input_ids"][i])
                    and np.array_equal(rb["labels"][i], pb["labels"][i]))
            differ += 0 if same else 1
    differ += abs(len(ref_b) - len(prog["batches"])) * data["batch_size"]
    checks = [Check("batch_rows_differing", float(differ), float(limits["batch_rows_differing"]),
                    differ)]

    precision = Precision("fp8" if control else "fp32")
    losses, g1, init, p3 = reference_steps(sd, student_cfg, teacher_cfg, ref_b, dist=dist,
                                           opt=opt, mix=mix, precision=precision,
                                           device=device)
    names = {hf_name(p): p for p in prog["p0"]}
    keys = sorted(set(names) & set(init))
    missing = len(set(init) ^ set(names))
    init_gap = max((float((prog["p0"][names[k]].to(device) - init[k]).abs().max())
                    for k in keys), default=float("inf"))
    checks.append(Check("init_max_abs", init_gap if not missing else float("inf"),
                        float(limits["init_max_abs"]), missing))
    if control:  # the control stands in the program's place
        prog_loss, prog_g = losses, g1
        prog_d = {k: p3[k] - init[k] for k in keys}
        losses, g1, init, p3 = reference_steps(sd, student_cfg, teacher_cfg, ref_b, dist=dist,
                                               opt=opt, mix=mix, precision=Precision(),
                                               device=device)
    else:
        prog_loss = prog["losses"]
        prog_g = {k: prog["mu1"][names[k]].to(device) / (1 - B1) for k in keys}
        prog_d = {k: prog["p3"][names[k]].to(device) - prog["p0"][names[k]].to(device)
                  for k in keys}
    ref_d = {k: p3[k] - init[k] for k in keys}
    n_loss = int(limits.get("loss_steps", 3))
    rel = [abs(a - b) / abs(b) for a, b in zip(prog_loss, losses)]
    checks.append(Check("loss_rel_gap", max(rel[:n_loss]), float(limits["loss_rel_gap"]),
                        sum(r > limits["loss_rel_gap"] for r in rel[:n_loss]),
                        detail={"losses": [float(x) for x in prog_loss],
                                "reference": [float(x) for x in losses]}))
    gg = _worst_norm_gap(prog_g, g1, keys)
    checks.append(Check("grad_norm_gap", gg, float(limits["grad_norm_gap"]), int(gg > limits["grad_norm_gap"])))
    gn = {k: float(g1[k].double().norm()) for k in keys}
    med = float(np.median(list(gn.values())))
    moving = [k for k in keys if gn[k] >= 1e-3 * med]
    cg = _worst_norm_gap(prog_d, ref_d, moving)
    cos = {k: float((prog_d[k].double().flatten() @ ref_d[k].double().flatten())
                    / (prog_d[k].double().norm() * ref_d[k].double().norm() + 1e-300))
           for k in moving}
    low = sorted(cos, key=cos.get)[:3]
    checks.append(Check("change_norm_gap", cg, float(limits["change_norm_gap"]),
                        int(cg > limits["change_norm_gap"]),
                        detail={"lowest_cosines": {k: cos[k] for k in low}}))
    return checks
