"""The scores kernel's launch plan (``repro_torch.kernels.binary_attn.plan``)
and the plain version it is held to, on the CPU.

* The plan is plain Python and is what the wrapper hands the C launcher:
  its tiles cover every (b * G + g, folded row, key) exactly once, through
  the same arithmetic as the kernel's grid; it fills the H100's 132 SMs
  wherever the work has that many tiles; it asks for no more shared memory
  than a block may take; it keeps a ring of at least two stages wherever a
  block walks more than one key tile, and walks only at a decode (one row
  tile); and its tiles are the ones ``csrc/binary_attn.cu`` is built for.
* ``ref.binary_attn_scores_ref`` (the kernel's plain version) and the
  wrapper on CPU tensors equal the reference's jnp core
  ``binary_attn_scores_planes`` bit for bit when K's last word carries set
  bits past dh: Q's zero tail masks them.
"""

import math
import re
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as JP
from repro.kernels import binary_attn as JBA
from repro_torch.core import packing
from repro_torch.kernels import binary_attn as K5
from repro_torch.kernels import ref
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

CU = Path(K5.__file__).resolve().parents[1] / "csrc" / "binary_attn.cu"

# ((B, H, S), (B, G, T), dh): chip_smoke.py's [12a] cases (bit-bert-base's
# 128-token prefill and 4-slot decode, a GQA decode, MLA's latent decode,
# ragged, bit-bert's 512-token prefill, granite-8b's 1,024-token prefill,
# the dirty-K-tail case, MLA's latent decode over 32,768 rows), then the
# card tests' tile edges: T one under and one over a key tile, 15 / 16 / 17
# folded rows, dw 9 (dh 288), dh 2048, a 512-token GQA prefill, and long
# decodes whose blocks walk key tiles (the last group short).
SMOKE_SHAPES = [
    ((1, 12, 128), (1, 12, 128), 64), ((4, 12, 1), (4, 12, 512), 64),
    ((4, 32, 1), (4, 8, 512), 128), ((4, 16, 1), (4, 1, 2048), 512),
    ((2, 6, 5), (2, 3, 333), 100), ((1, 12, 512), (1, 12, 512), 64),
    ((1, 32, 1024), (1, 8, 1024), 128), ((2, 8, 9), (2, 2, 300), 100),
    ((4, 16, 1), (4, 1, 32768), 512),
]
EDGE_SHAPES = [
    ((1, 4, 2), (1, 1, 31), 64), ((1, 4, 2), (1, 1, 33), 64),
    ((2, 8, 8), (2, 1, 127), 64), ((2, 8, 8), (2, 1, 129), 64),
    ((3, 5, 3), (3, 1, 200), 128), ((2, 4, 4), (2, 1, 200), 128), ((1, 17, 1), (1, 1, 200), 128),
    ((2, 4, 3), (2, 2, 65), 288), ((1, 2, 70), (1, 1, 1), 2048),
    ((1, 32, 512), (1, 8, 512), 128), ((4, 12, 1), (4, 12, 8292), 64), ((8, 32, 1), (8, 8, 4100), 128),
]


def _dw(dh: int) -> int:
    return packing.packed_len(dh, 1)


def _tile_origins(p: dict, t: int):
    """``(block, b * G + g, first row, first key)`` of every tile the
    kernel's blocks walk under plan ``p``: the arithmetic of its launch
    (block (x, y, z) takes rows y * rows .. of (b, g) = z and key tiles
    x * tiles_per_block .., fewer in the last group)."""
    key_tiles = -(-t // p["keys"])
    gx, gy, gz = p["grid"]
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                for kt in range(x * p["tiles_per_block"], min((x + 1) * p["tiles_per_block"], key_tiles)):
                    yield (x, y, z), z, y * p["rows"], kt * p["keys"]


@pytest.mark.parametrize("q_shape,k_shape,dh", SMOKE_SHAPES + EDGE_SHAPES)
def test_plan_tiles_cover_every_output_once(q_shape, k_shape, dh):
    (b, h, s), (_, g, t) = q_shape, k_shape
    p = K5.plan(b, h, g, s, t, _dw(dh))
    m = (h // g) * s
    seen = np.zeros((b * g, m, t), dtype=np.int8)
    walked = Counter()
    for blk, bg, m0, t0 in _tile_origins(p, t):
        assert 0 <= bg < b * g and 0 <= m0 < m and 0 <= t0 < t
        seen[bg, m0:m0 + p["rows"], t0:t0 + p["keys"]] += 1
        walked[blk] += 1
    assert (seen == 1).all()
    assert len(walked) == p["blocks"] == math.prod(p["grid"])
    assert sum(walked.values()) == p["tiles"] and max(walked.values()) == p["tiles_per_block"]


@pytest.mark.parametrize("q_shape,k_shape,dh", SMOKE_SHAPES)
def test_plan_fills_the_card_where_the_work_allows(q_shape, k_shape, dh):
    (b, h, s), (_, g, t) = q_shape, k_shape
    p = K5.plan(b, h, g, s, t, _dw(dh))
    m = (h // g) * s
    most = max(-(-m // r) * -(-t // k) * b * g for r, k in K5.TILES)
    assert p["blocks"] >= min(K5.SMS, most)


def test_plan_at_the_smoke_shapes():
    """The tiles and grids ``PERF.md`` reports for chip_smoke.py's [12a]."""
    got = [(p["rows"], p["keys"], p["blocks"], p["tiles_per_block"], p["stages"])
           for p in (K5.plan(b, h, g, s, t, _dw(dh)) for (b, h, s), (_, g, t), dh in SMOKE_SHAPES)]
    assert got == [(32, 32, 192, 1, 1), (8, 128, 192, 1, 1), (8, 64, 256, 1, 1), (16, 32, 256, 1, 1),
                   (8, 32, 132, 1, 1), (64, 128, 384, 1, 1), (64, 128, 4096, 1, 1), (8, 32, 200, 1, 1),
                   (16, 128, 256, 4, 3)]


@pytest.mark.parametrize("dw", [1, 2, 4, 9, 16, 64, 300, 700])
@pytest.mark.parametrize("shape", [(1, 32, 8, 1024, 1024), (4, 16, 1, 1, 2048), (1, 2, 1, 70, 1)])
def test_plan_shared_memory_and_stages(dw, shape):
    b, h, g, s, t = shape
    p = K5.plan(b, h, g, s, t, dw)
    assert p["smem"] == K5.smem_bytes(p["rows"], p["keys"], p["stages"], dw) <= K5.SMEM_LIMIT
    per = p["tiles_per_block"]
    assert min(2, per) <= p["stages"] <= min(K5.MAX_STAGES, per)
    assert per == 1 or p["grid"][1] == 1
    assert p["threads"] == K5.threads(p["rows"], p["keys"]) in (64, 128)


def test_plan_refuses_a_head_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        K5.plan(1, 1, 1, 1, 64, 1000)


def test_plan_tiles_are_the_kernels():
    """Every tile the plan may pick is one the launcher instantiates."""
    built = {(int(r), int(k)) for r, k in re.findall(r"BINARY_ATTN_TILE\((\d+), (\d+)\)", CU.read_text())}
    assert built == set(K5.TILES)
    assert len(K5.TILES) == 12


@pytest.mark.parametrize("shape", [(2, 8, 2, 9, 300, 100), (1, 4, 4, 3, 40, 33), (2, 6, 3, 5, 70, 200)])
def test_plain_scores_mask_a_dirty_k_tail_as_the_reference(shape):
    """K's last word carries set bits past dh; Q is packed from {0, 1} bits,
    so its tail is zero and AND masks them, in the reference's core, its
    numpy oracle, the plain version and the wrapper on CPU tensors."""
    b, h, g, s, t, dh = shape
    rng = np.random.default_rng(list(shape))
    qbits = rng.integers(0, 2, size=(b, h, s, dh)).astype(np.uint32)
    kbits = rng.integers(0, 2, size=(b, g, t, dh)).astype(np.uint32)
    qn = np.asarray(JP.pack_bits(jnp.asarray(qbits), 1, axis=-1))
    kn = np.asarray(JP.pack_bits(jnp.asarray(kbits), 1, axis=-1)).copy()
    junk = rng.integers(0, 2**32, size=kn.shape[:-1], dtype=np.uint64).astype(np.uint32)
    kn[..., -1] |= junk & np.uint32((0xFFFFFFFF << (dh % 32)) & 0xFFFFFFFF)
    assert (kn[..., -1] >> np.uint32(dh % 32)).any()
    want = np.asarray(JBA.binary_attn_scores_planes(jnp.asarray(qn), jnp.asarray(kn), dh=dh))
    clean = np.einsum("bgxsd,bgtd->bgxst", qbits.reshape(b, g, h // g, s, dh).astype(np.int64),
                      kbits.astype(np.int64)).reshape(b, h, s, t)
    np.testing.assert_array_equal(want, clean)
    qt = torch.from_numpy(qn.view(np.int32).copy())
    kt = torch.from_numpy(kn.view(np.int32).copy())
    np.testing.assert_array_equal(ref.binary_attn_scores_ref(qt, kt, dh).numpy(), want)
    np.testing.assert_array_equal(K5.binary_attn_scores_planes(qt, kt, dh=dh).numpy(), want)
