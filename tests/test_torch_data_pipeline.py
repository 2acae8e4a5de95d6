"""The port's synthetic token stream (``repro_torch.data.pipeline``): its
batches bit for bit the reference's over seeds, steps, shard splits and
with frontend embeddings, and the reference's behaviours of
``tests/test_data_pipeline.py`` on the port."""

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)


def _cfg(**kw):
    base = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=7)
    base.update(kw)
    return DataConfig(**base)


@pytest.mark.parametrize("seed", [0, 3, 7, 12345])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_batches_equal_reference(seed, shards):
    """Every shard's first five batches, and a batch far along the stream."""
    kw = dict(vocab_size=30522, seq_len=48, global_batch=8, seed=seed)
    for shard in range(shards):
        mine = TokenPipeline(DataConfig(**kw), shard_index=shard, num_shards=shards)
        ref = JTokenPipeline(JDataConfig(**kw), shard_index=shard, num_shards=shards)
        assert mine._shift == ref._shift
        for _ in range(5):
            a, b = mine.next(), ref.next()
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(mine._batch_at(10_000)["tokens"], ref._batch_at(10_000)["tokens"])


def test_frontend_batches_equal_reference():
    kw = dict(vocab_size=256, seq_len=16, global_batch=4, seed=5, frontend_positions=12, frontend_dim=24)
    mine, ref = TokenPipeline(DataConfig(**kw)), JTokenPipeline(JDataConfig(**kw))
    for _ in range(3):
        a, b = mine.next(), ref.next()
        assert set(a) == set(b) == {"tokens", "frontend"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_config_fields_equal_reference():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(DataConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JDataConfig)]


def test_deterministic_across_instances():
    a = TokenPipeline(_cfg())
    b = TokenPipeline(_cfg())
    for _ in range(3):
        np.testing.assert_array_equal(a.next()["tokens"], b.next()["tokens"])


def test_shards_are_disjoint_slices_of_global():
    s0 = TokenPipeline(_cfg(), shard_index=0, num_shards=2)
    s1 = TokenPipeline(_cfg(), shard_index=1, num_shards=2)
    b0, b1 = s0.next()["tokens"], s1.next()["tokens"]
    assert b0.shape == (4, 32) and b1.shape == (4, 32)
    assert not np.array_equal(b0, b1)


def test_indivisible_batch_rejected():
    with pytest.raises(ValueError):
        TokenPipeline(_cfg(global_batch=6), num_shards=4)


def test_resume_from_cursor_is_bit_identical():
    a = TokenPipeline(_cfg())
    for _ in range(5):
        a.next()
    state = a.state()
    want = a.next()["tokens"]
    b = TokenPipeline(_cfg())
    b.restore(state)
    np.testing.assert_array_equal(b.next()["tokens"], want)


def test_reshard_keeps_cursor():
    a = TokenPipeline(_cfg(), shard_index=0, num_shards=2)
    a.next(), a.next()
    b = a.reshard(0, 4)
    assert b.cursor == 2
    assert b.local_batch == 2


def test_seed_mismatch_rejected():
    a = TokenPipeline(_cfg())
    b = TokenPipeline(_cfg(seed=8))
    with pytest.raises(ValueError):
        b.restore(a.state())


def test_stream_is_learnable_not_uniform():
    """The n-gram echo makes token t predictable from token t - 3."""
    p = TokenPipeline(_cfg(seq_len=256, global_batch=4))
    toks = p.next()["tokens"]
    echo = (np.roll(toks, 3, axis=1) + p._shift) % 1000
    match = (toks[:, 3:] == echo[:, 3:]).mean()
    assert 0.15 < match < 0.7, f"echo rate {match}"


def test_frontend_embeddings_emitted():
    p = TokenPipeline(_cfg(frontend_positions=12, frontend_dim=24))
    b = p.next()
    assert b["frontend"].shape == (8, 12, 24)
    assert b["frontend"].dtype == np.float32
