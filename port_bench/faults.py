"""Faults planted in the port's timed path, to see ``correct`` come out
false (the CPU tests) and to read what each does to the compared numbers
at a cell's own size (``readings.py --fault``). Each takes
``patch(obj, attr, new)``, which replaces an attribute for the run."""

import torch


def token_altered(patch):
    """Greedy's token at step 3 of every row is another one."""
    from taiwan_whisper_tpu_torch.decode import greedy

    orig = greedy.greedy_rules_argmax

    def altered(logits, **state):
        nxt, lp = orig(logits, **state)
        if state["step"] == 3:
            nxt = (nxt + 7) % logits.shape[-1]
        return nxt, lp
    patch(greedy, "greedy_rules_argmax", altered)


def beam_token_altered(patch):
    """The best hypothesis of every beam-search row gets another token at
    step 3."""
    from taiwan_whisper_tpu_torch.decode import longform

    orig = longform.beam_decode

    def altered(params, enc, prefix, *args, **kwargs):
        res = orig(params, enc, prefix, *args, **kwargs)
        i = prefix.shape[1] + 3
        with torch.inference_mode():
            res.tokens[:, i] = (res.tokens[:, i] + 7) % 50364
        return res
    patch(longform, "beam_decode", altered)


def half_batch_label(patch):
    """A labelling batch decodes its first half; the second half's rows are
    left out and come back empty (only ``<|endoftext|>``)."""
    from taiwan_whisper_tpu_torch.pipeline import label

    orig = label.decode_audio

    def half(params, audio, prefix, *args, **kwargs):
        res = orig(params, audio, prefix, *args, **kwargs)
        h = max(audio.shape[0] // 2, 1)
        with torch.inference_mode():
            res.tokens[h:, prefix.shape[1]:] = 50257
            res.lengths[h:] = 0
        return res
    patch(label, "decode_audio", half)


def state_unchanged(patch):
    """The optimizer returns no update: the step leaves its state as it was."""
    from taiwan_whisper_tpu_torch.train import state

    patch(state.Optimizer, "update", lambda self, grads, st, params: ({}, st))


def half_batch_train(patch):
    """The loss of a train step takes the first half of the batch's rows, its
    mean over their tokens."""
    from taiwan_whisper_tpu_torch.train import distill

    orig = distill.distill_loss

    def half(student, teacher, batch, *args, **kwargs):
        h = max(batch["labels"].shape[0] // 2, 1)
        return orig(student, teacher, {k: v[:h] for k, v in batch.items()}, *args, **kwargs)
    patch(distill, "distill_loss", half)


def bias_dropped(patch):
    """The weights the port loads lose one encoder bias (layer 0's fc1) and
    one LayerNorm shift (the decoder's last): both read as zero."""
    from taiwan_whisper_tpu_torch.models import params

    orig = params.load_hf_state_dict

    def dropped(state_dict, config):
        p = orig(state_dict, config)
        for leaf in (p["encoder"]["layers"][0]["fc1"], p["decoder"]["ln_post"]):
            leaf["bias"] = torch.zeros_like(leaf["bias"])
        return p
    patch(params, "load_hf_state_dict", dropped)


FAULTS = {f.__name__: f for f in (token_altered, beam_token_altered, half_batch_label,
                                  state_unchanged, half_batch_train, bias_dropped)}
