"""The port's serving step (opensearch_tpu_torch/parallel/distributed.py)
against the reference's shard_map program, on the CPU.

The reference runs S shards over S virtual devices; the port runs them as
one stacked batch. Both get the same numpy arrays (the port through
interop.bundle_from_numpy). Global ids and per-shard counts must be equal;
scores equal at the int8 pool level and to rtol 1e-5 (fp32, and int8 and
bf16 after the exact fp32 rescore), because the two frameworks sum the d
products in another order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax.sharding import Mesh

from opensearch_tpu.parallel import distributed as jax_dist
from opensearch_tpu_torch import interop
from opensearch_tpu_torch.parallel import distributed as torch_dist

DIM = 16
SIMS = ("l2_norm", "cosine", "dot_product")


def _inputs(seed, s, n=256, d=DIM, b=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, d)) * 4
    vectors = (centers[rng.integers(0, 6, (s, n))]
               + rng.standard_normal((s, n, d))).astype(np.float32)
    norms = (vectors.astype(np.float64) ** 2).sum(2).astype(np.float32)
    valid = rng.random((s, n)) > 0.1
    queries = rng.standard_normal((b, d)).astype(np.float32) * 4
    return vectors, norms, valid, queries


def _jax_step(s, kernel, precision, similarity, arrays):
    mesh = Mesh(np.array(jax.devices()[:s]), ("data",))
    step = jax_dist.build_knn_serving_step(
        mesh, k_shard=8, k_final=min(10, 8 * s), similarity=similarity,
        kernel=kernel, score_precision=precision, interpret=True)
    return tuple(map(np.asarray, step(*map(jnp.asarray, arrays))))


def _torch_step(kernel, precision, similarity, arrays):
    vectors, norms, valid, queries = arrays
    bundle = interop.bundle_from_numpy(vectors, norms, valid, device="cpu")
    step = torch_dist.build_knn_serving_step(
        k_shard=8, k_final=min(10, 8 * len(vectors)), similarity=similarity,
        kernel=kernel, score_precision=precision)
    vals, gids, counts = step(bundle.vectors, bundle.norms_sq, bundle.valid,
                              torch.from_numpy(queries))
    return vals.numpy(), gids.numpy(), counts.numpy()


@pytest.mark.parametrize("precision", ("fp32", "bf16", "int8"))
@pytest.mark.parametrize("kernel", ("pallas", "xla"))
@pytest.mark.parametrize("s", (1, 2, 4))
def test_serving_step_matches_reference(s, kernel, precision):
    arrays = _inputs(21 + s, s)
    for similarity in SIMS:
        jv, jg, jc = _jax_step(s, kernel, precision, similarity, arrays)
        tv, tg, tc = _torch_step(kernel, precision, similarity, arrays)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=0)


def test_fused_step_keeps_empty_slots_explicit():
    """A shard with fewer live docs than k_shard: the fused step carries
    (-inf, -1) instead of wrapping into the neighbour shard's id range,
    and counts are the finite winners per shard."""
    vectors, norms, valid, queries = _inputs(5, 2)
    valid[1] = False
    valid[1, :3] = True
    vals, gids, counts = _torch_step("pallas", "fp32", "l2_norm",
                                     (vectors, norms, valid, queries))
    assert (counts[1] == 3).all() and (counts[0] == 8).all()
    assert np.isfinite(vals).all()          # 11 live candidates >= k_final
    jv, jg, jc = _jax_step(2, "pallas", "fp32", "l2_norm",
                           (vectors, norms, valid, queries))
    np.testing.assert_array_equal(gids, jg)
    np.testing.assert_array_equal(counts, jc)


def test_segment_vectors_from_numpy_keeps_the_host_norms():
    """interop.segment_vectors_from_numpy: the reference's norm formula
    (float64 sum, then float32) bit for bit, padding rows absent."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((37, DIM)).astype(np.float32) * 7
    present = rng.random(37) > 0.2
    vf = interop.segment_vectors_from_numpy(
        vecs, present, similarity="l2_norm", device="cpu", n_pad=128)
    want = (vecs.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    np.testing.assert_array_equal(vf.norms_sq.numpy()[:37], want)
    np.testing.assert_array_equal(vf.present.numpy()[:37], present)
    assert not vf.present.numpy()[37:].any()
    assert tuple(vf.vectors.shape) == (128, DIM) and vf.dims == DIM
