"""The forward kernel's tile-skip rule (``flash_attention.visited_k_tiles``,
the plain mirror of ``flash_fwd.cu``'s loop) against the dense mask: it never
skips a tile that holds a visible (query, key) pair, it skips every tile
whose segment-id range is disjoint from the Q tile's, and without segment ids
it visits exactly the tiles below the causal and kv bounds. The kernel loads
the tiles of its 64-row blocks and each warp computes those of its 16 rows,
which nest inside them. Ids are drawn in any order, with the packer's -1
padding.
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


def _visited(lay):
    ids = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    return fa.visited_k_tiles(
        lay["b"], lay["t_q"], lay["t_kv"], causal=lay["causal"],
        causal_offset=lay["t_kv"] - lay["t_q"], kv_lengths=torch.tensor(lay["kv_len"]),
        q_seg=ids(lay["q_ids"]), kv_seg=ids(lay["kv_ids"]), block_q=lay["block_q"],
        block_k=lay["block_k"]).numpy()


@SETTINGS
@given(_layouts())
def test_never_skips_a_tile_with_a_visible_pair(lay):
    vis = _dense_visible(lay["b"], lay["t_q"], lay["t_kv"], lay["causal"], lay["kv_len"],
                         lay["q_ids"], lay["kv_ids"])
    needed = _tiles(vis, lay["block_q"], lay["block_k"])
    visited = _visited(lay)
    assert visited.shape == needed.shape
    assert not (needed & ~visited).any()


@SETTINGS
@given(_layouts().filter(lambda lay: lay["q_ids"] is not None))
def test_skips_every_tile_with_disjoint_id_ranges(lay):
    bq, bk = lay["block_q"], lay["block_k"]
    visited = _visited(lay)
    for b in range(lay["b"]):
        for i in range(visited.shape[1]):
            q = lay["q_ids"][b, i * bq:(i + 1) * bq]
            for j in range(visited.shape[2]):
                kv = lay["kv_ids"][b, j * bk:(j + 1) * bk]
                if kv.max() < q.min() or kv.min() > q.max():
                    assert not visited[b, i, j]


@SETTINGS
@given(_layouts())
def test_warp_tiles_nest_in_block_tiles(lay):
    lay = dict(lay, block_q=fa.FWD_BLOCK_Q, block_k=fa.FWD_BLOCK_K)
    block = _visited(lay)
    warp = _visited(dict(lay, block_q=fa.FWD_WARP_Q))
    per_block = fa.FWD_BLOCK_Q // fa.FWD_WARP_Q
    warp = np.pad(warp, ((0, 0), (0, -warp.shape[1] % per_block), (0, 0)))
    warp = warp.reshape(lay["b"], -1, per_block, warp.shape[2]).any(axis=2)
    assert not (warp & ~block).any()


@pytest.mark.parametrize("causal,t_q,t_kv,kv_len", [
    (True, 200, 200, [200, 200]),
    (True, 70, 50, [50, 50]),
    (True, 24, 130, [130, 130]),
    (False, 100, 100, [100, 33]),
    (False, 64, 64, [0, 64]),
])
def test_without_segments_visits_the_loop_bound(causal, t_q, t_kv, kv_len):
    bq, bk = fa.FWD_BLOCK_Q, fa.FWD_BLOCK_K
    visited = fa.visited_k_tiles(2, t_q, t_kv, causal=causal, causal_offset=t_kv - t_q,
                                 kv_lengths=torch.tensor(kv_len)).numpy()
    for b in range(2):
        for i in range(visited.shape[1]):
            k_end = kv_len[b]
            if causal:
                k_end = min(k_end, i * bq + bq + t_kv - t_q)
            want = [j * bk < k_end for j in range(visited.shape[2])]
            assert visited[b, i].tolist() == want


def test_packed_rows_skip_most_of_the_causal_triangle():
    rng = np.random.RandomState(0)
    t = 4096
    ids = torch.tensor(np.sort(rng.randint(0, 8, (2, t)), axis=1), dtype=torch.int32)
    causal = fa.visited_k_tiles(2, t, t, causal=True)
    packed = fa.visited_k_tiles(2, t, t, causal=True, q_seg=ids, kv_seg=ids)
    one = torch.zeros_like(ids)
    assert torch.equal(fa.visited_k_tiles(2, t, t, causal=True, q_seg=one, kv_seg=one),
                       causal)
    n_q, per_tile = t // fa.FWD_BLOCK_Q, fa.FWD_BLOCK_Q // fa.FWD_BLOCK_K
    assert int(causal.sum()) == 2 * per_tile * n_q * (n_q + 1) // 2
    assert int(packed.sum()) * 4 < int(causal.sum())
    vis = _dense_visible(2, t, t, True, np.array([t, t]), ids.numpy(), ids.numpy())
    assert int(packed.sum()) * fa.FWD_BLOCK_Q * fa.FWD_BLOCK_K >= vis.sum()


@pytest.mark.parametrize("block_q", [fa.FWD_BLOCK_Q, fa.FWD_WARP_Q])
def test_single_token_segments_visit_only_the_diagonal(block_q):
    t, bk = 300, fa.FWD_BLOCK_K
    ids = torch.arange(t, dtype=torch.int32)[None].repeat(2, 1)
    visited = fa.visited_k_tiles(2, t, t, causal=True, q_seg=ids, kv_seg=ids,
                                 block_q=block_q)
    i, j = np.ogrid[:visited.shape[1], :visited.shape[2]]
    diagonal = (j * bk < (i + 1) * block_q) & ((j + 1) * bk > i * block_q)
    assert (visited.numpy() == diagonal[None]).all()


def test_mirror_blocks_match_the_kernel_source():
    src = os.path.join(os.path.dirname(fa.__file__), "csrc", "flash_fwd.cu")
    with open(src) as f:
        text = f.read()
    found = dict(re.findall(r"constexpr int (BQ|WQ) = (\d+);", text))
    found.update(re.findall(r"#define PTT_FWD_(BK) (\d+)\n", text))  # BK's default
    assert "constexpr int BK = PTT_FWD_BK;" in text
    assert found == {"BQ": str(fa.FWD_BLOCK_Q), "WQ": str(fa.FWD_WARP_Q),
                     "BK": str(fa.FWD_BLOCK_K)}
