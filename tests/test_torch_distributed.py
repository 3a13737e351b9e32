"""The tensor-parallel hybrid program (parallel/distributed.
build_distributed_search) against the reference's, on the same numpy
inputs.

The reference runs its ``shard_map`` program over the 8 virtual CPU
devices tests/conftest.py gives it; the port runs the same mesh of slots
on one CPU device. The two cases of tests/test_distributed.py come over
at n_model 1 and 2, with the ring on and off, at l2, cosine and
dot_product:

- on sixteenths data every dot and |q|^2 is exact in any order, so the
  vector scores and the ids are the reference's bit for bit. With the
  lexical part on, one case is named: XLA on the CPU contracts the BM25
  denominator's multiply-adds (``tfs + k1 * (1 - b + b * dl / avgdl)``)
  into fused multiply-adds, which the port's one-op-at-a-time f32 does
  not, so a doc's BM25 sum may differ by a few ulps (the port's equals
  the same formula in numpy f32 bit for bit); ids stay equal;
- on floats the values agree to rtol 1e-5, the ids wherever no two
  scores lie within 1e-5 of each other;
- per-shard BM25 statistics (IDFs, avgdl, term windows) differ from shard
  to shard;
- the ring gives the all-gather's values, and its ids but at equal scores
  (its tie order is the reference's: slot 0 merges shard 0, then S - 1,
  S - 2, ...);
- d % n_model != 0 raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.parallel import distributed as ref_dist
from opensearch_tpu.parallel.mesh import build_mesh as ref_build_mesh
from opensearch_tpu_torch import interop
from opensearch_tpu_torch.parallel import distributed as port_dist
from opensearch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    build_mesh,
    shard_spec,
)

S, N_PAD, D, B, K, Q, P_PAD, WINDOW = 4, 64, 16, 3, 5, 4, 128, 16
SIMS = ("l2_norm", "cosine", "dot_product")
# the BM25 FMA contraction's bound on a hybrid score (see the docstring)
LEXICAL_ULPS = 8


def _inputs(rng, *, sixteenths: bool, lexical: bool) -> dict:
    if sixteenths:
        v = (rng.integers(-16, 17, (S, N_PAD, D)) / 16).astype(np.float32)
        q = (rng.integers(-16, 17, (B, D)) / 16).astype(np.float32)
    else:
        v = rng.standard_normal((S, N_PAD, D)).astype(np.float32)
        q = rng.standard_normal((B, D)).astype(np.float32)
    valid = np.ones((S, N_PAD), bool)
    valid[:, -3:] = False  # padding rows
    valid[1, 7] = False    # a deleted doc
    return {
        "vectors": v,
        "norms_sq": (v.astype(np.float64) ** 2).sum(-1).astype(np.float32),
        "valid": valid,
        "postings_docs": rng.integers(0, N_PAD - 3, (S, P_PAD)).astype(
            np.int32),
        "postings_tfs": rng.integers(1, 5, (S, P_PAD)).astype(np.float32),
        "doc_len": rng.integers(5, 50, (S, N_PAD)).astype(np.float32),
        "queries": q,
        # per shard: its own term windows, IDFs and average doc length
        "offsets": rng.integers(0, P_PAD - WINDOW, (S, Q)).astype(np.int32),
        "lengths": (rng.integers(0, WINDOW + 1, (S, Q)) if lexical
                    else np.zeros((S, Q))).astype(np.int32),
        "idfs": rng.uniform(0.5, 3.0, (S, Q)).astype(np.float32),
        "avgdl": rng.uniform(10.0, 40.0, S).astype(np.float32),
        "lexical_weight": 0.3 if lexical else 0.0,
        "vector_weight": 1.0,
    }


_SEG_KEYS = ("vectors", "norms_sq", "valid", "postings_docs",
             "postings_tfs", "doc_len")


def _reference(inp: dict, *, n_model: int, ring: bool, similarity: str,
               k: int = K):
    mesh = ref_build_mesh(n_data=S, n_model=n_model)
    segs = ref_dist.ShardedSegments(*(jnp.asarray(inp[key])
                                      for key in _SEG_KEYS))
    qargs = ref_dist.QueryArgs(
        query_vectors=jnp.asarray(inp["queries"]),
        term_offsets=jnp.asarray(inp["offsets"]),
        term_lengths=jnp.asarray(inp["lengths"]),
        term_idfs=jnp.asarray(inp["idfs"]),
        avgdl=jnp.asarray(inp["avgdl"]),
        lexical_weight=jnp.float32(inp["lexical_weight"]),
        vector_weight=jnp.float32(inp["vector_weight"]),
    )
    with mesh:
        fn = ref_dist.build_distributed_search(
            mesh, k=k, window=WINDOW, similarity=similarity, ring=ring)
        vals, ids = jax.block_until_ready(
            fn(ref_dist.shard_arrays_to_mesh(mesh, segs), qargs))
    return np.asarray(vals), np.asarray(ids).astype(np.int64)


def _port(inp: dict, *, n_model: int, ring: bool, similarity: str,
          k: int = K):
    mesh = build_mesh(n_data=S, n_model=n_model, devices=["cpu"])
    segs = interop.sharded_segments_from_numpy(
        *(inp[key] for key in _SEG_KEYS), device="cpu")
    qargs = interop.query_args_from_numpy(
        inp["queries"], inp["offsets"], inp["lengths"], inp["idfs"],
        inp["avgdl"], inp["lexical_weight"], inp["vector_weight"],
        device="cpu")
    fn = port_dist.build_distributed_search(
        mesh, k=k, window=WINDOW, similarity=similarity, ring=ring)
    vals, ids = fn(port_dist.shard_arrays_to_mesh(mesh, segs), qargs)
    return vals.numpy(), ids.numpy()


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n_model", [1, 2])
def test_sixteenths_vector_part_is_the_references_bits(n_model, ring,
                                                       similarity):
    rng = np.random.default_rng(100 + n_model * 10 + ring)
    inp = _inputs(rng, sixteenths=True, lexical=False)
    rv, ri = _reference(inp, n_model=n_model, ring=ring,
                        similarity=similarity)
    pv, pi = _port(inp, n_model=n_model, ring=ring, similarity=similarity)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv.view(np.int32), rv.view(np.int32))


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n_model", [1, 2])
def test_sixteenths_hybrid_ids_equal_scores_within_the_bm25_fma_case(
        n_model, ring, similarity):
    """The named case: XLA's fused multiply-adds in the BM25 denominator
    move a hybrid score by a few ulps; the ids are the reference's."""
    rng = np.random.default_rng(200 + n_model * 10 + ring)
    inp = _inputs(rng, sixteenths=True, lexical=True)
    rv, ri = _reference(inp, n_model=n_model, ring=ring,
                        similarity=similarity)
    pv, pi = _port(inp, n_model=n_model, ring=ring, similarity=similarity)
    np.testing.assert_array_equal(pi, ri)
    assert _ulps(pv, rv).max() <= LEXICAL_ULPS


def test_bm25_part_is_the_one_op_at_a_time_f32_formula():
    """The lexical part alone (vector weight 0) against the BM25 formula
    in numpy f32, one operation at a time and each doc's contributions
    added in (term, window slot) order: bit for bit."""
    rng = np.random.default_rng(3)
    inp = _inputs(rng, sixteenths=True, lexical=True)
    inp["vector_weight"], inp["lexical_weight"] = 0.0, 1.0
    pv, pi = _port(inp, n_model=1, ring=False, similarity="l2_norm",
                   k=N_PAD)
    f32 = np.float32
    for s in range(S):
        lex = np.zeros(N_PAD, np.float32)
        for t in range(Q):
            lo = int(inp["offsets"][s, t])
            for p in range(lo, lo + int(inp["lengths"][s, t])):
                doc = int(inp["postings_docs"][s, p])
                tf = inp["postings_tfs"][s, p]
                dl = inp["doc_len"][s, doc]
                denom = tf + f32(1.2) * ((f32(1.0) - f32(0.75))
                                         + f32(0.75) * dl
                                         / inp["avgdl"][s])
                lex[doc] = lex[doc] + inp["idfs"][s, t] * tf / denom
        for row in range(B):
            got = {int(i) - s * N_PAD: v for v, i in zip(pv[row], pi[row])
                   if s * N_PAD <= i < (s + 1) * N_PAD and np.isfinite(v)}
            for doc, v in got.items():
                assert np.float32(v).view(np.int32) == \
                    lex[doc].view(np.int32), (s, doc)


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n_model", [1, 2])
def test_floats_within_rtol_ids_equal_but_at_near_ties(n_model, ring,
                                                       similarity):
    rng = np.random.default_rng(300 + n_model * 10 + ring)
    inp = _inputs(rng, sixteenths=False, lexical=True)
    rv, ri = _reference(inp, n_model=n_model, ring=ring,
                        similarity=similarity)
    pv, pi = _port(inp, n_model=n_model, ring=ring, similarity=similarity)
    np.testing.assert_allclose(pv, rv, rtol=1e-5)
    # a rank may hold another id only where its score lies within 1e-5
    # (relative) of a neighbour's
    tol = 1e-5 * np.abs(rv)
    near = np.zeros_like(rv, bool)
    gap = np.abs(np.diff(rv, axis=1)) <= tol[:, 1:]
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    np.testing.assert_array_equal(pi[~near], ri[~near])


def test_the_references_two_cases():
    """tests/test_distributed.py's cases on the port: the kNN top-k equals
    the numpy l2 brute force, and a fat posting run on shard 0 makes its
    doc 7 win every query."""
    rng = np.random.default_rng(0)
    inp = _inputs(rng, sixteenths=False, lexical=False)
    for n_model in (1, 2):
        for ring in (False, True):
            pv, pi = _port(inp, n_model=n_model, ring=ring,
                           similarity="l2_norm")
            flat = inp["vectors"].reshape(S * N_PAD, D).astype(np.float64)
            d2 = ((inp["queries"][:, None, :].astype(np.float64)
                   - flat[None]) ** 2).sum(-1)
            want = 1.0 / (1.0 + d2)
            want[:, ~inp["valid"].reshape(-1)] = -np.inf
            order = np.argsort(-want, axis=1, kind="stable")[:, :K]
            np.testing.assert_allclose(
                pv, np.take_along_axis(want, order, axis=1), rtol=1e-4)
            np.testing.assert_array_equal(pi, order)
    inp = _inputs(rng, sixteenths=False, lexical=False)
    inp["postings_docs"][0, :16] = 7
    inp["offsets"][:] = 0
    inp["lengths"][:] = np.array([16, 0, 0, 0], np.int32)
    inp["idfs"][:] = 2.0
    inp["avgdl"][:] = 20.0
    inp["lexical_weight"] = 100.0
    pv, pi = _port(inp, n_model=2, ring=False, similarity="l2_norm", k=4)
    assert pi[:, 0].tolist() == [7] * B


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("n_model", [1, 2])
def test_ring_gives_the_allgathers_values_and_ids_but_at_ties(n_model,
                                                              similarity):
    rng = np.random.default_rng(400 + n_model)
    inp = _inputs(rng, sixteenths=True, lexical=True)
    av, ai = _port(inp, n_model=n_model, ring=False, similarity=similarity)
    rv, ri = _port(inp, n_model=n_model, ring=True, similarity=similarity)
    np.testing.assert_array_equal(rv.view(np.int32), av.view(np.int32))
    diff = ri != ai
    # where the ids differ, the two hold equal scores at that rank
    assert np.all(rv[diff] == av[diff])


def test_ring_ties_go_to_slot_zero_then_its_left_neighbours():
    """Every doc scores the same: the all-gather's ties go to the lowest
    shard, the ring's (data slot 0's) to shard 0 then S - 1, S - 2, ...,
    as the reference's ppermute ring gives them."""
    rng = np.random.default_rng(5)
    inp = _inputs(rng, sixteenths=True, lexical=False)
    inp["vectors"][:] = 0.5
    inp["norms_sq"][:] = (0.5 ** 2) * D
    inp["valid"][:] = True
    k = 2 * N_PAD
    for ring in (False, True):
        rv, ri = _reference(inp, n_model=1, ring=ring, similarity="l2_norm",
                            k=k)
        pv, pi = _port(inp, n_model=1, ring=ring, similarity="l2_norm", k=k)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pv, rv)
        shards = (pi[0] // N_PAD).tolist()
        want = [0] * N_PAD + ([S - 1] * N_PAD if ring else [1] * N_PAD)
        assert shards == want


def test_d_not_a_multiple_of_the_model_axis_raises():
    rng = np.random.default_rng(6)
    inp = _inputs(rng, sixteenths=True, lexical=False)
    inp["vectors"] = inp["vectors"][:, :, :15]
    inp["queries"] = inp["queries"][:, :15]
    with pytest.raises(ValueError, match="multiple of the model axis"):
        _port(inp, n_model=2, ring=False, similarity="l2_norm")


def test_shard_count_must_match_the_data_axis():
    rng = np.random.default_rng(7)
    inp = _inputs(rng, sixteenths=True, lexical=False)
    mesh = build_mesh(n_data=S - 1, devices=["cpu"])
    segs = interop.sharded_segments_from_numpy(
        *(inp[key] for key in _SEG_KEYS), device="cpu")
    qargs = interop.query_args_from_numpy(
        inp["queries"], inp["offsets"], inp["lengths"], inp["idfs"],
        inp["avgdl"], 0.0, 1.0, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        port_dist.build_distributed_search(mesh, k=K, window=WINDOW)(
            segs, qargs)


def test_mesh_is_a_grid_of_slots_on_one_device():
    mesh = build_mesh(n_data=4, n_model=2, devices=["cpu"])
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert shard_spec(mesh, DATA_AXIS, None).spec == (DATA_AXIS, None)
    # a list of several devices is the reference's rule: the first N
    # devices reshaped, and a list too short raises
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        build_mesh(4, 2, devices=["cpu", "cpu"])
    two = build_mesh(2, 1, devices=["cpu:0", "cpu:1"])
    assert [str(d) for d in two.devices.flat] == ["cpu:0", "cpu:1"]
    # laid out slot by slot: each shard's two column slices, the other
    # arrays' rows, every one a tensor on its slot's device
    segs = port_dist.shard_arrays_to_mesh(mesh, port_dist.ShardedSegments(
        np.zeros((4, 3, 4), np.float32),
        *(np.zeros((4, 3), np.float32) for _ in range(5))))
    assert [[tuple(t.shape) for t in row] for row in segs.vectors] == \
        [[(3, 2), (3, 2)]] * 4
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in [*(t for row in segs.vectors for t in row),
                         *(t for field in segs[1:] for t in field)])


def test_default_device_is_the_card():
    """The mesh's default device is the card: without one it raises,
    never a quiet CPU run."""
    if torch.cuda.is_available():
        assert build_mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_mesh(2)


def test_merge_topk_ties_go_to_the_first_operand():
    a_v = torch.tensor([[3.0, 1.0]])
    a_i = torch.tensor([[10, 11]])
    b_v = torch.tensor([[3.0, 2.0]])
    b_i = torch.tensor([[20, 21]])
    vals, ids = port_dist._merge_topk(a_v, a_i, b_v, b_i, 3)
    assert vals.tolist() == [[3.0, 3.0, 2.0]]
    assert ids.tolist() == [[10, 20, 21]]
