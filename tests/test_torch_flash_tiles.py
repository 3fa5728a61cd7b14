"""The tile-skip rules of the three tile-skipping kernels against the dense
mask: the forward's and the dQ kernel's (``flash_attention.visited_k_tiles``,
the plain mirror of ``flash_fwd.cu``'s and ``flash_bwd_dq.cu``'s loops: K
tiles per Q tile, with each kernel's tiles) and the dK/dV kernel's
(``visited_q_tiles``, of ``flash_bwd_dkv.cu``: Q tiles per K tile, the same
test with Q and K swapped). Each property runs over every kernel's mirror: a
mirror never skips a tile that holds a visible (query, key) pair, it skips
every tile whose segment-id range is disjoint from the other tile's, and
without segment ids it visits exactly the tiles its loop bounds give. Each
kernel's blocks load the tiles of their block and each warp computes those
of its 16 rows (forward, dQ) or 16 keys (dK/dV), which nest inside them. Ids
are drawn in any order, with the packer's -1 padding.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from petastorm_tpu_torch.ops import flash_attention as fa

SETTINGS = settings(max_examples=80, deadline=None, database=None, derandomize=True)


def _tiles(x, rows, cols):
    """[B, R, C] bool -> [B, ceil(R / rows), ceil(C / cols)]: any per tile."""
    b, r, c = x.shape
    x = np.pad(x, ((0, 0), (0, -r % rows), (0, -c % cols)))
    return x.reshape(b, x.shape[1] // rows, rows, x.shape[2] // cols, cols).any(axis=(2, 4))


def _dense_visible(b, t_q, t_kv, causal, kv_len, q_ids, kv_ids):
    rows, cols = np.arange(t_q)[:, None], np.arange(t_kv)[None, :]
    vis = np.broadcast_to(cols[None] < kv_len[:, None, None], (b, t_q, t_kv)).copy()
    if causal:
        vis &= cols <= rows + (t_kv - t_q)
    if q_ids is not None:
        vis &= q_ids[:, :, None] == kv_ids[:, None, :]
    return vis


@st.composite
def _ids(draw, b, t):
    """Unsorted ids in [-1, 5], or packed rows: sorted runs then a -1 tail."""
    if draw(st.booleans()):
        return np.array(draw(st.lists(st.lists(st.integers(-1, 5), min_size=t, max_size=t),
                                      min_size=b, max_size=b)), np.int32)
    ids = np.full((b, t), -1, np.int32)
    for row in ids:
        used = draw(st.integers(0, t))
        cuts = sorted(draw(st.lists(st.integers(0, used), max_size=4)))
        for seg, (start, end) in enumerate(zip([0] + cuts, cuts + [used])):
            row[start:end] = seg
    return ids


@st.composite
def _layouts(draw):
    b = draw(st.integers(1, 2))
    t_q = draw(st.integers(1, 80))
    pair = draw(st.booleans())
    t_kv = draw(st.integers(1, 80)) if pair else t_q
    seg = draw(st.booleans())
    q_ids = draw(_ids(b, t_q)) if seg else None
    kv_ids = (draw(_ids(b, t_kv)) if pair else q_ids) if seg else None
    kv_len = np.array(draw(st.lists(st.integers(0, t_kv), min_size=b, max_size=b))
                      if draw(st.booleans()) else [t_kv] * b)
    return dict(b=b, t_q=t_q, t_kv=t_kv, causal=draw(st.booleans()), kv_len=kv_len,
                q_ids=q_ids, kv_ids=kv_ids, block_q=draw(st.sampled_from([1, 4, 8, 16])),
                block_k=draw(st.sampled_from([1, 4, 8, 32])))


#: kernel -> (its block tile, warp tile), as (block_q, block_k) pairs: the
#: forward's and dQ's warps split their Q tile, dK/dV's warps its K tile.
KERNEL_TILES = {
    "fwd": ((fa.FWD_BLOCK_Q, fa.FWD_BLOCK_K), (fa.FWD_WARP_Q, fa.FWD_BLOCK_K)),
    "dq": ((fa.DQ_BLOCK_Q, fa.DQ_BLOCK_K), (fa.DQ_WARP_Q, fa.DQ_BLOCK_K)),
    "dkv": ((fa.DKV_BLOCK_Q, fa.DKV_BLOCK_K), (fa.DKV_BLOCK_Q, fa.DKV_WARP_K)),
}
MIRRORS = sorted(KERNEL_TILES)


def _visited(lay, mirror):
    """The mirror's visited tiles as ``[B, Q tiles, K tiles]`` (dK/dV's
    ``[B, K tiles, Q tiles]`` transposed)."""
    ids = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    kw = dict(causal=lay["causal"], causal_offset=lay["t_kv"] - lay["t_q"],
              kv_lengths=torch.tensor(lay["kv_len"]), q_seg=ids(lay["q_ids"]),
              kv_seg=ids(lay["kv_ids"]), block_q=lay["block_q"], block_k=lay["block_k"])
    if mirror != "dkv":
        return fa.visited_k_tiles(lay["b"], lay["t_q"], lay["t_kv"], **kw).numpy()
    return fa.visited_q_tiles(lay["b"], lay["t_q"], lay["t_kv"], **kw).transpose(1, 2).numpy()


def _kernel_tile(lay, mirror, tile):
    """``lay`` with the kernel's block (0) or warp (1) tile, or as drawn."""
    if tile is None:
        return lay
    block_q, block_k = KERNEL_TILES[mirror][tile]
    return dict(lay, block_q=block_q, block_k=block_k)


@pytest.mark.parametrize("mirror", MIRRORS)
@SETTINGS
@given(lay=_layouts(), tile=st.sampled_from([None, 0, 1]))
def test_never_skips_a_tile_with_a_visible_pair(mirror, lay, tile):
    lay = _kernel_tile(lay, mirror, tile)
    vis = _dense_visible(lay["b"], lay["t_q"], lay["t_kv"], lay["causal"], lay["kv_len"],
                         lay["q_ids"], lay["kv_ids"])
    needed = _tiles(vis, lay["block_q"], lay["block_k"])
    visited = _visited(lay, mirror)
    assert visited.shape == needed.shape
    assert not (needed & ~visited).any()


@pytest.mark.parametrize("mirror", MIRRORS)
@SETTINGS
@given(lay=_layouts().filter(lambda lay: lay["q_ids"] is not None),
       tile=st.sampled_from([None, 0, 1]))
def test_skips_every_tile_with_disjoint_id_ranges(mirror, lay, tile):
    lay = _kernel_tile(lay, mirror, tile)
    bq, bk = lay["block_q"], lay["block_k"]
    visited = _visited(lay, mirror)
    for b in range(lay["b"]):
        for i in range(visited.shape[1]):
            q = lay["q_ids"][b, i * bq:(i + 1) * bq]
            for j in range(visited.shape[2]):
                kv = lay["kv_ids"][b, j * bk:(j + 1) * bk]
                if kv.max() < q.min() or kv.min() > q.max():
                    assert not visited[b, i, j]


@pytest.mark.parametrize("mirror", MIRRORS)
@SETTINGS
@given(lay=_layouts())
def test_warp_tiles_nest_in_block_tiles(mirror, lay):
    (bq, bk), (wq, wk) = KERNEL_TILES[mirror]
    lay = dict(lay, block_q=bq, block_k=bk)
    block = _visited(lay, mirror)
    warp = _visited(dict(lay, block_q=wq, block_k=wk), mirror)
    per_q, per_k = bq // wq, bk // wk  # warps per block along each axis
    warp = np.pad(warp, ((0, 0), (0, -warp.shape[1] % per_q), (0, -warp.shape[2] % per_k)))
    warp = warp.reshape(lay["b"], warp.shape[1] // per_q, per_q, warp.shape[2] // per_k,
                        per_k).any(axis=(2, 4))
    assert not (warp & ~block).any()


@pytest.mark.parametrize("mirror", MIRRORS)
@pytest.mark.parametrize("causal,t_q,t_kv,kv_len", [
    (True, 200, 200, [200, 200]),
    (True, 70, 50, [50, 50]),
    (True, 24, 130, [130, 130]),
    (False, 100, 100, [100, 33]),
    (False, 64, 64, [0, 64]),
])
def test_without_segments_visits_the_loop_bound(mirror, causal, t_q, t_kv, kv_len):
    """The forward and dQ: a Q tile takes every K tile that starts below its
    keys' end (kv bound, last row's diagonal). dK/dV: a K tile holding a key
    below the kv bound takes every Q tile that holds a row below T_q at or
    after its first key's diagonal row."""
    (bq, bk), _ = KERNEL_TILES[mirror]
    lay = dict(b=2, t_q=t_q, t_kv=t_kv, causal=causal, kv_len=np.array(kv_len), q_ids=None,
               kv_ids=None, block_q=bq, block_k=bk)
    visited = _visited(lay, mirror)
    for b in range(2):
        for i in range(visited.shape[1]):
            for j in range(visited.shape[2]):
                if mirror != "dkv":
                    k_end = kv_len[b]
                    if causal:
                        k_end = min(k_end, i * bq + bq + t_kv - t_q)
                    want = j * bk < k_end
                else:
                    r_begin = j * bk - (t_kv - t_q) if causal else 0
                    want = j * bk < kv_len[b] and max(r_begin, i * bq) < min(t_q, i * bq + bq)
                assert visited[b, i, j] == want


@pytest.mark.parametrize("mirror", MIRRORS)
def test_packed_rows_skip_most_of_the_causal_triangle(mirror):
    rng = np.random.RandomState(0)
    t = 4096
    ids = np.sort(rng.randint(0, 8, (2, t)), axis=1).astype(np.int32)
    (bq, bk), _ = KERNEL_TILES[mirror]
    lay = dict(b=2, t_q=t, t_kv=t, causal=True, kv_len=np.array([t, t]), q_ids=None,
               kv_ids=None, block_q=bq, block_k=bk)
    causal = _visited(lay, mirror)
    packed = _visited(dict(lay, q_ids=ids, kv_ids=ids), mirror)
    one = np.zeros_like(ids)
    assert (_visited(dict(lay, q_ids=one, kv_ids=one), mirror) == causal).all()
    vis = _dense_visible(2, t, t, True, np.array([t, t]), ids, ids)
    assert (causal == _tiles(vis | np.tril(np.ones((t, t), bool)), bq, bk)).all()
    assert int(packed.sum()) * 4 < int(causal.sum())
    assert int(packed.sum()) * bq * bk >= vis.sum()


@pytest.mark.parametrize("mirror,tile", [(m, t) for m in MIRRORS for t in (0, 1)])
def test_single_token_segments_visit_only_the_diagonal(mirror, tile):
    """Each kernel's block tile (0) and warp tile (1)."""
    t = 300
    block_q, bk = KERNEL_TILES[mirror][tile]
    ids = np.arange(t, dtype=np.int32)[None].repeat(2, 0)
    lay = dict(b=2, t_q=t, t_kv=t, causal=True, kv_len=np.array([t, t]), q_ids=ids,
               kv_ids=ids, block_q=block_q, block_k=bk)
    visited = _visited(lay, mirror)
    i, j = np.ogrid[:visited.shape[1], :visited.shape[2]]
    diagonal = (j * bk < (i + 1) * block_q) & ((j + 1) * bk > i * block_q)
    assert (visited == diagonal[None]).all()


def test_mirror_blocks_match_the_kernel_source():
    src = os.path.join(os.path.dirname(fa.__file__), "csrc", "flash_fwd.cu")
    with open(src) as f:
        text = f.read()
    found = dict(re.findall(r"constexpr int (BQ|WQ) = (\d+);", text))
    found.update(re.findall(r"#define PTT_FWD_(BK) (\d+)\n", text))  # BK's default
    assert "constexpr int BK = PTT_FWD_BK;" in text
    assert found == {"BQ": str(fa.FWD_BLOCK_Q), "WQ": str(fa.FWD_WARP_Q),
                     "BK": str(fa.FWD_BLOCK_K)}


def test_dq_mirror_blocks_match_the_kernel_source():
    src = os.path.join(os.path.dirname(fa.__file__), "csrc", "flash_bwd_dq.cu")
    with open(src) as f:
        text = f.read()
    found = dict(re.findall(r"constexpr int (BQ|WQ) = (\d+);", text))
    found.update(re.findall(r"#define PTT_DQ_(BK) (\d+)\n", text))  # BK's default
    assert "constexpr int BK = PTT_DQ_BK;" in text
    assert found == {"BQ": str(fa.DQ_BLOCK_Q), "WQ": str(fa.DQ_WARP_Q),
                     "BK": str(fa.DQ_BLOCK_K)}


def test_dkv_mirror_blocks_match_the_kernel_source():
    src = os.path.join(os.path.dirname(fa.__file__), "csrc", "flash_bwd_dkv.cu")
    with open(src) as f:
        text = f.read()
    found = dict(re.findall(r"constexpr int (BK|WK) = (\d+);", text))
    found.update(re.findall(r"#define PTT_DKV_(BQ) (\d+)\n", text))  # BQ's default
    assert "constexpr int BQ = PTT_DKV_BQ;" in text
    assert found == {"BK": str(fa.DKV_BLOCK_K), "WK": str(fa.DKV_WARP_K),
                     "BQ": str(fa.DKV_BLOCK_Q)}
