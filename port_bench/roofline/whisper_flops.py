"""Model FLOPs of Whisper from shapes: two per multiply-add of every
matrix product the model needs (convolutions, projections, attention
products, logits). Elementwise work, softmax and normalisation are not
counted, nor recomputation. ``cfg`` is a configuration file's dict."""

T_ENC = 1500


def _tok_layer(d: int, f: int, self_keys: int, cross_keys: int) -> float:
    """One decoder layer for one token: self q/k/v/out, cross q/out, MLP,
    and the attention products over ``self_keys`` and ``cross_keys``."""
    return 2 * (4 * d * d + 2 * d * d + 2 * d * f) + 4 * d * (self_keys + cross_keys)


def encoder(cfg: dict) -> float:
    """One 30 s row through the encoder."""
    d, f, m = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    t = cfg["max_source_positions"]
    stem = 2 * (2 * t) * m * 3 * d + 2 * t * d * 3 * d
    layer = 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
    return stem + cfg["encoder_layers"] * layer


def cross_kv(cfg: dict) -> float:
    """K and V of every decoder layer over one row's encoder output."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    return cfg["decoder_layers"] * 2 * 2 * t * d * d


def decoder_tokens(cfg: dict, start: int, n: int, logits: int) -> float:
    """``n`` tokens at positions ``start``.. through every decoder layer,
    causal self attention, and ``logits`` rows of the output head."""
    d, f, v = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["vocab_size"]
    t = cfg["max_source_positions"]
    per = sum(_tok_layer(d, f, start + i + 1, t) for i in range(n))
    return cfg["decoder_layers"] * per + logits * 2 * d * v


def label_row_flops(cfg: dict, *, prefix: int, tokens: int) -> float:
    """One labelled row, from what it served: the encoder, the cross K/V,
    the prefill of ``prefix`` positions (its last position's logits) and
    one decode step with logits for each of its ``tokens`` served tokens
    (the step that feeds it back). Pad rows and the steps a row idles
    while others finish are not work."""
    return (encoder(cfg) + cross_kv(cfg) + decoder_tokens(cfg, 0, prefix, 1)
            + decoder_tokens(cfg, prefix, tokens, tokens))


def train_sample_flops(student: dict, teacher: dict = None, *, tokens: int) -> float:
    """One training sample: the frozen encoder's forward, the teacher
    decoder's forward over ``tokens`` positions (distillation), and the
    student decoder's forward and backward (twice the forward, but once
    for the cross K/V projections of the frozen encoder's output)."""
    fwd_student = cross_kv(student) + decoder_tokens(student, 0, tokens, tokens)
    total = encoder(student) + 3 * fwd_student - cross_kv(student)
    if teacher is not None:
        total += cross_kv(teacher) + decoder_tokens(teacher, 0, tokens, tokens)
    return total
