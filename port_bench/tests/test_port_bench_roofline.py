"""The frozen FLOP counts and bounds against hand counts at large-v2's
shapes."""

import json
import os

import pytest

from port_bench.roofline import bound_s, cross_attn, enc_attn
from port_bench.roofline import whisper_flops as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def large_v2():
    with open(os.path.join(ROOT, "port_bench", "configs", "whisper-large-v2.json")) as f:
        return json.load(f)


def test_encoder_of_one_chunk(large_v2):
    d, f, t = 1280, 5120, 1500
    stem = 2 * 3000 * 80 * 3 * d + 2 * 1500 * d * 3 * d
    layer = 2 * t * (4 * d * d + 2 * d * f) + 2 * 2 * t * t * d
    assert F.encoder(large_v2) == stem + 32 * layer
    assert F.encoder(large_v2) == pytest.approx(2.2727e12, rel=1e-4)


def test_cross_kv_and_a_decode_step(large_v2):
    d, f, v = 1280, 5120, 51865
    assert F.cross_kv(large_v2) == 32 * 2 * 2 * 1500 * d * d
    # the token at position 10: 11 self keys, 1500 cross keys, and its logits
    per_layer = 2 * (6 * d * d + 2 * d * f) + 4 * d * (11 + 1500)
    assert F.decoder_tokens(large_v2, 10, 1, 1) == 32 * per_layer + 2 * d * v


def test_label_batch(large_v2):
    one = F.label_row_flops(large_v2, prefix=3, tokens=192)
    assert one == F.encoder(large_v2) + F.cross_kv(large_v2) + \
        F.decoder_tokens(large_v2, 0, 3, 1) + F.decoder_tokens(large_v2, 3, 192, 192)
    assert one * 32 == pytest.approx(94.4e12, rel=2e-3)
    # a row that served fewer tokens did less work
    assert F.label_row_flops(large_v2, prefix=3, tokens=10) < one


def test_train_sample(large_v2):
    student = dict(large_v2, decoder_layers=2)
    fwd = F.cross_kv(student) + F.decoder_tokens(student, 0, 447, 447)
    teacher = F.cross_kv(large_v2) + F.decoder_tokens(large_v2, 0, 447, 447)
    assert F.train_sample_flops(student, tokens=447) == \
        F.encoder(student) + 3 * fwd - F.cross_kv(student)
    assert F.train_sample_flops(student, large_v2, tokens=447) == \
        F.train_sample_flops(student, tokens=447) + teacher


def test_bounds_match_the_kernel_table():
    """Rows 2 and 4 of the port's kernel table (PERF.md): the encoder
    attention at b32 is bound by operations at 0.373 ms, the fp8 cross
    kernel at one row by bytes at 0.0368 ms."""
    assert enc_attn.bound((32, 1500, 20, 64), 2) * 1e3 == pytest.approx(0.373, abs=5e-4)
    assert cross_attn.bound((32, 1, 20, 64), 1, (32, 20, 64, 1500), 1, 2) * 1e3 == \
        pytest.approx(0.0368, abs=5e-5)
    # five beams fold into the query rows against K/V stored once
    assert cross_attn.bound((40, 1, 20, 64), 5, (8, 20, 64, 1500), 1, 2) * 1e3 == \
        pytest.approx(0.0093, abs=5e-5)


def test_bound_takes_the_larger():
    assert bound_s(3.35e12, 0.0, "bf16") == pytest.approx(1.0)
    assert bound_s(0.0, 989e12, "bf16") == pytest.approx(1.0)
    assert bound_s(3.35e12, 2 * 989e12, "bf16") == pytest.approx(2.0)
