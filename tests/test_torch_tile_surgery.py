"""PyTorch port: ``reproduce_tiles`` against the JAX ``tile_surgery`` (CPU).

Both packages get the same parents and the same numpy uniforms, fed row by
row to their ``urand``s, so every child must agree: opcodes exactly, and
constants to rtol 1e-6 (both compute Box-Muller in float32, but the CPU
``log``/``cos`` of the two backends may round differently by an ulp). The
number of uniform rows consumed must be equal too — it is the row layout
the CUDA kernel reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitreegp_tpu.core import tile_surgery as jts
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.trees import rebuild_pointers as jax_rebuild
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core import tile_surgery as tts
from multitreegp_tpu_torch.core.cuda_reproduction import reproduce_lanes, rows_per_lane
from multitreegp_tpu_torch.core.trees import rebuild_pointers, validate_host
from multitreegp_tpu_torch.ops.initialization import make_population_sampler

torch.set_num_threads(1)

N = 32
OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]


def parent_tiles(tf, lanes, seed):
    """(N, lanes) int32/float32 parents of every size class: single leaves,
    small, medium and nearly full trees (depth 1, 2, 4 and 5 samples)."""
    g = torch.Generator().manual_seed(seed)
    parts = [make_population_sampler(tf, depth, N)(g, lanes // 4)[0, :, 0] for depth in (1, 2, 4, 5)]
    perm = torch.randperm(lanes, generator=g)
    ops = torch.cat([p.ops for p in parts])[perm].T.contiguous().numpy()
    const = torch.cat([p.const for p in parts])[perm].T.contiguous().numpy()
    return ops, const


class NumpyRand:
    """``urand`` handing out consecutive rows of one numpy buffer."""

    def __init__(self, u, wrap):
        self.u, self.wrap, self.row = u, wrap, 0

    def __call__(self, rows):
        out = self.u[self.row:self.row + rows]
        self.row += rows
        return self.wrap(out)


KINDS = ("crossover", "copy", "mutate", "fresh")


@pytest.fixture(scope="module")
def setup():
    jf = jax_function_set(OPS, [["x0", "x1"], ["x1"]], [1, 1])
    tf = function_set_from_jax(jf)
    return jf, tf, jts.make_config(jf, N, 4), tts.make_config(tf, N, 4)


@pytest.fixture(scope="module")
def reproduced(setup):
    """One call of each package on 256 lanes: a quarter crossover lanes, the
    rest with every (act1, act2) combination of copy / mutate / fresh."""
    jf, tf, jcfg, tcfg = setup
    lanes = 256
    p1o, p1c = parent_tiles(tf, lanes, 10)
    p2o, p2c = parent_tiles(tf, lanes, 20)
    u = np.random.default_rng(0).random((rows_per_lane(tcfg), lanes), dtype=np.float32)
    lane = np.arange(lanes)
    cx = lane % 4 == 0
    act1 = np.where(cx, 0, (lane // 4) % 3).astype(np.int32)
    act2 = np.where(cx, 0, (lane // 12) % 3).astype(np.int32)
    # tree slot 0 may use x0 and x1, slot 1 only x1 (exercises variable exclusion)
    vmask = np.stack([np.ones(lanes), lane % 2 == 0]).astype(np.float32)
    jrand = NumpyRand(u, jnp.asarray)
    jout = jts.reproduce_tiles(
        jnp.asarray(p1o), jnp.asarray(p1c), jnp.asarray(p2o), jnp.asarray(p2c),
        jnp.asarray(cx)[None], jnp.asarray(act1)[None], jnp.asarray(act2)[None],
        jnp.asarray(vmask), jrand, jcfg,
    )
    trand = tts.BufferRand(torch.from_numpy(u))
    tout = tts.reproduce_tiles(
        torch.from_numpy(p1o), torch.from_numpy(p1c), torch.from_numpy(p2o), torch.from_numpy(p2c),
        torch.from_numpy(cx)[None], torch.from_numpy(act1)[None], torch.from_numpy(act2)[None],
        torch.from_numpy(vmask), trand, tcfg,
    )
    assert jrand.row == trand.row == u.shape[0]
    kinds = [np.where(cx, 0, act + 1) for act in (act1, act2)]  # index into KINDS per child
    return dict(parents=((p1o, p1c), (p2o, p2c)), u=u, kinds=kinds,
                jax=[np.asarray(a) for a in jout], torch=[t.numpy() for t in tout])


@pytest.mark.parametrize("kind", KINDS)
def test_reproduce_tiles_matches_jax(setup, reproduced, kind):
    jf, tf, jcfg, tcfg = setup
    k = KINDS.index(kind)
    for child in range(2):
        m = reproduced["kinds"][child] == k
        assert m.sum() >= 16
        jo, jc = reproduced["jax"][2 * child:2 * child + 2]
        to, tc = reproduced["torch"][2 * child:2 * child + 2]
        np.testing.assert_array_equal(to[:, m], jo[:, m])
        np.testing.assert_allclose(tc[:, m], jc[:, m], rtol=1e-6, atol=0)
        ops = torch.from_numpy(to[:, m].T.copy())
        c1, c2 = rebuild_pointers(ops, tf.slots())
        validate_host(trees_from_numpy(ops, c1, c2, tc[:, m].T), tf.slots())
        po = reproduced["parents"][child][0]
        changed = (to[:, m] != po[:, m]).any(axis=0).mean()
        assert changed == 0.0 if kind == "copy" else changed > 0.5
    if kind == "mutate":  # every mutation case is exercised
        node_rows = tf.num_variables + tf.num_operators + 4
        r_m1 = 2 * 15 * node_rows + 8 * 2 * N  # after two fresh trees and crossover
        m = reproduced["kinds"][0] == k
        which = tts.choose_row(
            tts.mutation_probs_tile(torch.from_numpy(reproduced["parents"][0][0][:, m]), tcfg),
            torch.from_numpy(reproduced["u"][r_m1:r_m1 + 7][:, m]),
        )
        assert set(which[0].tolist()) == set(range(7))


def test_reproduce_lanes_cpu_dispatch_and_checks(setup):
    jf, tf, jcfg, tcfg = setup
    lanes = 16
    p1o, p1c = parent_tiles(tf, lanes, 30)
    args = [torch.from_numpy(a) for a in (p1o, p1c, p1o, p1c)]
    ctrl = [torch.zeros(lanes, dtype=torch.bool), torch.ones(lanes, dtype=torch.int32),
            torch.full((lanes,), 2, dtype=torch.int32)]
    vmask = torch.ones((2, lanes))
    u = torch.rand((rows_per_lane(tcfg), lanes), generator=torch.Generator().manual_seed(0))
    out = reproduce_lanes(*args, *ctrl, vmask, u, tcfg)
    ref = tts.reproduce_tiles(*args, ctrl[0][None], ctrl[1][None], ctrl[2][None], vmask,
                              tts.BufferRand(u), tcfg)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):  # a uniform buffer of the wrong height
        reproduce_lanes(*args, *ctrl, vmask, u[:-1], tcfg)


def test_rows_per_lane_counts_the_jax_draws(setup):
    jf, tf, jcfg, tcfg = setup
    # 2 fresh trees, crossover, 2 mutations: (V + K + 4) rows per sampled node
    v, k = tf.num_variables, tf.num_operators
    node = v + k + 4
    leaf = v + 3
    mut = 7 + 3 * node + 2 * N + leaf + 8 * (N + k) + 2 * leaf + N + leaf + k + 1 + N + k + 1
    assert rows_per_lane(tcfg) == 2 * 15 * node + 8 * 2 * N + 2 * mut


def test_rebuilt_pointers_match_jax(setup):
    jf, tf, _, _ = setup
    ops, _ = parent_tiles(tf, 32, 40)
    c1, c2 = rebuild_pointers(torch.from_numpy(ops.T.copy()), tf.slots())
    jc1, jc2 = jax_rebuild(jnp.asarray(ops.T), jf.slots)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
