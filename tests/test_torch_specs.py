"""The port's tensor-parallel layout (taiwan_whisper_tpu_torch/parallel/
specs.py) against the JAX package's ``param_partition_specs``, leaf by
leaf through ``from_jax_params``: each JAX leaf becomes a marker array
that counts along its split axis (zeros when replicated), the bridge
transposes and unstacks it, and the one dim along which the port's leaf
then varies must be the port's split dim. Then the cuts and their
refusals: shards concatenate back to the full leaf, and a split that does
not divide raises."""

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.parallel.specs import param_partition_specs
from taiwan_whisper_tpu_torch.models.config import WhisperConfig, get_config
from taiwan_whisper_tpu_torch.models.params import from_jax_params, init_params, named_leaves
from taiwan_whisper_tpu_torch.parallel import specs

CFG = dict(vocab_size=256, num_mel_bins=80, d_model=64, ffn_dim=128, encoder_layers=2,
           decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
           max_source_positions=60, max_target_positions=32)


def _markers(params, spec_tree):
    """Each JAX leaf as an array of its shape counting 0, 1, ... along the
    axis its spec puts on ``model`` (zeros when replicated)."""
    import jax

    def mark(leaf, spec):
        shape = np.shape(leaf)
        axes = [i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(shape, np.float32)
        (axis,) = axes
        view = [1] * len(shape)
        view[axis] = shape[axis]
        return np.broadcast_to(np.arange(shape[axis], dtype=np.float32).reshape(view),
                               shape).copy()

    return jax.tree.map(mark, params, spec_tree,
                        is_leaf=lambda x: type(x).__name__ == "PartitionSpec")


def _varying_dims(t: torch.Tensor):
    return [d for d in range(t.dim())
            if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]


@pytest.fixture(scope="module")
def jax_layout():
    cfg = JaxConfig(**CFG)
    params = jax_init_params(cfg, seed=0)
    return params, param_partition_specs(params)


def test_split_dims_match_jax_partition_specs(jax_layout):
    params, spec_tree = jax_layout
    marked = from_jax_params(_markers(params, spec_tree), WhisperConfig(**CFG))
    split = []
    for path, t in named_leaves(marked):
        want = specs.split_dim(path)
        assert _varying_dims(t) == ([] if want is None else [want]), path
        if want is not None:
            split.append(path)
    # per layer: q/k/v weights, q/v biases, out weight of each attention,
    # fc1 weight and bias, fc2 weight (the k projections carry no bias)
    assert len(split) == 2 * 9 + 2 * 15
    assert specs.split_dim("decoder.embed_tokens") is None
    assert specs.split_dim("decoder.layers.1.cross_attn.out.bias") is None
    assert specs.split_dim("encoder.layers.0.fc2.bias") is None


@pytest.mark.parametrize("size", [1, 2, 4])
def test_shards_concatenate_to_the_full_tree(size):
    cfg = WhisperConfig(**CFG)
    full = init_params(cfg, seed=3)
    shards = [specs.shard_params(full, r, size, cfg) for r in range(size)]
    for path, t in named_leaves(full):
        parts = [dict(named_leaves(s))[path] for s in shards]
        dim = specs.split_dim(path)
        if dim is None or size == 1:
            assert all(p is t for p in parts), path
        else:
            assert all(p.shape[dim] == t.shape[dim] // size for p in parts), path
            assert torch.equal(torch.cat(parts, dim), t), path
    # a model rank holds heads / size whole heads of every attention
    q = shards[0]["decoder"]["layers"][0]["self_attn"]["q"]["weight"]
    assert q.shape == (cfg.d_model // size, cfg.d_model)


@pytest.mark.parametrize("name,size", [("large-v2", 2), ("large-v2", 4), ("base", 2),
                                       ("base", 4), ("base", 8)])
def test_shipped_models_divide(name, size):
    specs.check_divisible(get_config(name), size)


@pytest.mark.parametrize("field,value,size", [
    ("encoder_attention_heads", 6, 4), ("decoder_attention_heads", 6, 4),
    ("d_model", 66, 4), ("ffn_dim", 130, 4)])
def test_uneven_split_raises(field, value, size):
    cfg = WhisperConfig(**dict(CFG, **{field: value}))
    with pytest.raises(ValueError, match=f"does not divide {field} {value}"):
        specs.check_divisible(cfg, size)


def test_uneven_leaf_raises():
    """Without a config to check first, the first split leaf refuses."""
    full = init_params(WhisperConfig(**CFG), seed=0)
    with pytest.raises(ValueError, match=r"encoder\.layers\.0\.self_attn\.q\.weight: dim 0 "
                                         r"of \(64, 64\) does not divide by 3"):
        specs.shard_params(full, 0, 3)
