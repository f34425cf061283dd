"""PyTorch port: sharded island evolution over gloo ranks on the CPU
(``parallel/mesh.py``, ``parallel/collective.py``, ``fit(shard=True)``),
against the JAX package's unsharded functions and the port's own unsharded
path.

W = 2 and 4 ranks are spawned with ``torch.multiprocessing.spawn``, their
group's store a ``FileStore`` under the test's temporary directory; each
rank runs a worker function of this module and saves what it computed, and
the test compares in this process. This module imports JAX only inside test
functions, so the spawned ranks never import it.

* ring migration (identity evolve) at generation 1 equals JAX's
  ``migrate_ring`` on the tagged population of ``tests/test_collective.py``
  as id sets, and the port's ``migrate_ring`` exactly (row order included);
  no migration at generation 0; the same over ``make_mesh_2d(2)`` (2 x 1
  and 2 x 2 ranks);
* ``global_best`` equals the flat ``argmin`` exactly, ties included;
* the distributed top-k constant optimisation equals JAX's
  ``make_constant_optimiser`` on the unsharded winners (the reference
  scheme of ``tests/test_collective.py``), to rtol 1e-5, with ``top_k`` 50
  (above a rank's population) and 8;
* the sharded SR evaluation equals the unsharded one bit for bit;
* at W = 2: a sharded ``fit`` killed and resumed equals the uninterrupted
  one; on 3 islands (not divisible by 2) it equals ``fit()`` bit for bit;
  with the adaptive method it has the right shapes, finite fitness and a
  non-increasing history;
* at W = 1 (a one-rank group in this process) ``fit(shard=True)`` equals
  ``fit()`` bit for bit, fused and non-fused; ``mesh=`` is accepted and a
  conflicting ``device=`` raises.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.core.trees import TreeTensors, validate_host
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
from multitreegp_tpu_torch.ops.constant_opt import make_constant_optimiser
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from multitreegp_tpu_torch.ops.reproduction import migrate_ring
from multitreegp_tpu_torch.parallel import collective as coll
from multitreegp_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

ISLANDS, POP, TREES, NODES, MIG = 8, 6, 2, 8, 2
OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
TOP_KS = (50, 8)
TARGET = 1.5


def _tagged(seed: int):
    """The population of ``tests/test_collective.py``: const encodes a
    unique id per candidate; fitness uniform from a numpy seed."""
    ids = np.arange(ISLANDS * POP, dtype=np.float32).reshape(ISLANDS, POP)
    shape = (ISLANDS, POP, TREES, NODES)
    pop = dict(ops=np.ones(shape, np.int32), c1=np.full(shape, -1, np.int32),
               c2=np.full(shape, -1, np.int32),
               const=np.broadcast_to(ids[..., None, None], shape).astype(np.float32))
    fitness = np.random.default_rng(seed).uniform(size=(ISLANDS, POP)).astype(np.float32)
    return pop, fitness


def _trees(arrays) -> TreeTensors:
    return TreeTensors(*(torch.from_numpy(np.ascontiguousarray(arrays[k]))
                         for k in ("ops", "c1", "c2", "const")))


def _const_loss(pop, data=None):
    """A smooth per-candidate loss of the constants: Adam moves them."""
    return ((pop.const - TARGET) ** 2).sum(dim=(-1, -2))


def _sr_case():
    """8 islands x 4 VdP candidates of 2 trees, N = 16, 4 trajectories."""
    g = torch.Generator().manual_seed(3)
    pop = make_population_sampler(_fset(), 3, 16)(g, 32)[0]
    data = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 1.0, 0.2), batch_size=4)
    return pop.map(lambda x: x.reshape((8, 4) + x.shape[1:])), data


def _fset():
    from multitreegp_tpu_torch.core.registry import build_function_set

    return build_function_set(OPS, [["x0", "x1"]], [2])


# ------------------------------------------------------------ rank workers


def _rank_main(rank, world, store, out_dir, fn, args, backend="gloo"):
    torch.set_num_threads(1)
    if backend == "nccl":  # one card a rank
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, tmp: Path, *args, backend="gloo"):
    """Run ``fn(rank, world, *args)`` on ``world`` ranks (gloo on the CPU,
    or NCCL on one card each); their results in rank order."""
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(tmp), fn, args, backend),
             nprocs=world, join=True)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


def _identity_step(mesh):
    return coll.make_evolve_populations_collective(
        lambda p, f, g, a, b, c: p, mesh, migration_period=2, migration_size=MIG,
        reproduction_type_probabilities=torch.zeros(ISLANDS, 3),
        reproduction_probabilities=torch.zeros(ISLANDS),
        tournament_probabilities=torch.zeros(ISLANDS, 4))


def _primitives(rank, world, tagged, ties, sr):
    """Every collective of one rank: migration (1-D and 2-D meshes),
    the global best, the const-opt at each top-k, the sharded evaluation."""
    out = {}
    meshes = {"1d": pm.make_mesh(), "2d": pm.make_mesh_2d(2)}
    pop, fitness = _trees(tagged[0]), torch.from_numpy(tagged[1])
    for name, mesh in meshes.items():
        local, fit = pm.shard_population(pop, fitness, mesh)
        step = _identity_step(mesh)
        for gen in (0, 1):
            moved = step(local, fit, torch.Generator(), gen)
            out[f"migrate_{name}_gen{gen}"] = pm.gather_population(moved, None, mesh).const
        out[f"shape_{name}"] = mesh.shape
    mesh = meshes["1d"]
    local, fit = pm.shard_population(pop, torch.from_numpy(ties), mesh)
    best_fit, best = coll.global_best(fit, local, mesh)
    out["best"] = (float(best_fit), float(best.const[0, 0]))

    rng = np.random.default_rng(7)
    const = rng.normal(size=(ISLANDS, POP, TREES, NODES)).astype(np.float32)
    cpop = pop._replace(const=torch.from_numpy(const))
    cfit = torch.from_numpy(rng.uniform(size=(ISLANDS, POP)).astype(np.float32))
    optimise = make_constant_optimiser(_const_loss, gradient_steps=4)
    for k in TOP_KS:
        step = coll.make_constant_opt_collective(lambda c: optimise(c, None), mesh, k)
        lp, lf = step(*pm.shard_population(cpop, cfit, mesh))
        full, full_fit = pm.gather_population(lp, lf, mesh)
        out[f"constopt_{k}"] = (full.const, full_fit)

    sr_pop, data = sr
    evaluator = SREvaluator(_fset(), substeps=1)
    evaluate = coll.make_sharded_evaluator(
        lambda p: evaluator.evaluate_population(p.map(lambda x: x.reshape((-1,) + x.shape[2:])),
                                                data).reshape(p.ops.shape[0], -1), mesh)
    local = pm.shard_population(sr_pop, None, mesh)
    out["sr_fitness"] = pm.all_gather_cat(evaluate(local), mesh)
    flat = sr_pop.map(lambda x: x.reshape((-1,) + x.shape[2:]))
    out["sr_fitness_flat"] = coll.evaluate_flat_sharded(
        lambda f: evaluator.evaluate_population(f, data), flat, mesh)
    return out


class Killed(Exception):
    pass


class KillingEvaluator(SREvaluator):
    """Raises on its ``kill_at``-th population evaluation (counting from 0)."""

    def __init__(self, kill_at=None, **kwargs):
        super().__init__(**kwargs)
        self.kill_at, self.calls = kill_at, 0

    def evaluate_population(self, population, data):
        if self.calls == self.kill_at:
            raise Killed(f"killed at evaluation {self.calls}")
        self.calls += 1
        return super().evaluate_population(population, data)


def _gp(evaluator=None, generations=15, islands=2, **kwargs):
    return GeneticProgramming(
        num_generations=generations, population_size=16, num_populations=islands,
        fitness_function=evaluator or KillingEvaluator(substeps=1), operator_list=OPS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16, max_init_depth=3,
        elite_percentage=0.25, coefficient_optimisation=True, gradient_steps=2,
        coefficient_opt_top_k=4, migration_period=5, device="cpu", **kwargs)


def _vdp_data():
    g = torch.Generator().manual_seed(0)
    return generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 2.0, 0.2), batch_size=4)


def _run(gp, data, seed=1, **kwargs):
    return gp.fit(torch.Generator().manual_seed(seed), data, **kwargs)


def _flat(result):
    best, sols, pops, fitness = result
    return [best, *sols, *pops, fitness]


def _fits(rank, world, ck_dir):
    """The sharded fits of one rank: killed and resumed against
    uninterrupted (4 islands), 3 islands against ``fit()``, adaptive."""
    data, out = _vdp_data(), {}
    mesh = pm.make_mesh()
    path = str(Path(ck_dir) / "ck_{gen}.npz")
    want = _run(_gp(islands=4, mesh=mesh), data, shard=True)
    try:
        _run(_gp(KillingEvaluator(kill_at=10, substeps=1), islands=4, mesh=mesh), data,
             shard=True, checkpoint_path=path, checkpoint_every=5)
        out["killed"] = False
    except Killed:
        out["killed"] = True
    got = _run(_gp(islands=4, mesh=mesh), data, seed=99, shard=True, resume_from=path.format(gen=10))
    out["resume_equal"] = all(torch.equal(a, b) for a, b in zip(_flat(want), _flat(got)))
    out["ck15_exists"] = Path(path.format(gen=15)).exists()
    out["sharded_best"] = want[0]

    plain = _run(_gp(islands=3), data)
    sharded = _run(_gp(islands=3, mesh=mesh), data, shard=True)
    out["three_equal"] = all(torch.equal(a, b) for a, b in zip(_flat(plain), _flat(sharded)))

    adaptive = SREvaluator(substeps=1, method="adaptive", adaptive_method="dopri5",
                           adaptive_budget=40)
    gp = _gp(adaptive, generations=4, islands=4, mesh=mesh)
    best, sols, pops, fitness = _run(gp, data, shard=True)
    out["adaptive"] = dict(best=best, sols=sols.ops.shape, pops=pops.ops.shape, fitness=fitness)
    validate_host(pops.map(lambda x: x.reshape(-1, x.shape[-1])), gp.fset.slots())
    return out


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def primitives(request, tmp_path_factory):
    world = request.param
    tagged, ties = _tagged(0), np.random.default_rng(2).integers(0, 3, (ISLANDS, POP)).astype(np.float32)
    tmp = tmp_path_factory.mktemp(f"gloo{world}")
    return world, tagged, ties, _spawn(_primitives, world, tmp, tagged, ties, _sr_case())


def _jax_migrate(tagged):
    import jax.numpy as jnp

    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu.ops.reproduction import migrate_ring as jax_migrate_ring

    pop, fitness = tagged
    ref, _ = jax_migrate_ring(JaxTrees(*(jnp.asarray(pop[k]) for k in ("ops", "c1", "c2", "const"))),
                              jnp.asarray(fitness), MIG)
    return np.asarray(ref.const)


def test_collective_migration_matches_reference(primitives):
    world, tagged, _, results = primitives
    ref = _jax_migrate(tagged)
    port_ref, _ = migrate_ring(_trees(tagged[0]), torch.from_numpy(tagged[1]), MIG)
    for res in results:  # every rank holds the gathered result
        got = res["migrate_1d_gen1"].numpy()
        np.testing.assert_array_equal(np.sort(got[..., 0, 0], axis=1), np.sort(ref[..., 0, 0], axis=1))
        assert torch.equal(res["migrate_1d_gen1"], port_ref.const)
        np.testing.assert_array_equal(res["migrate_1d_gen0"].numpy(), tagged[0]["const"])
        assert res["shape_1d"] == (world,)


def test_collective_migration_2d_mesh(primitives):
    world, tagged, _, results = primitives
    ref = _jax_migrate(tagged)
    for res in results:
        assert res["shape_2d"] == (2, world // 2)
        got = res["migrate_2d_gen1"].numpy()
        np.testing.assert_array_equal(np.sort(got[..., 0, 0], axis=1), np.sort(ref[..., 0, 0], axis=1))
        assert torch.equal(res["migrate_2d_gen1"], res["migrate_1d_gen1"])


def test_global_best_matches_argmin(primitives):
    _, _, ties, results = primitives
    flat = ties.reshape(-1)
    assert (flat == flat.min()).sum() > 1  # ties across ranks
    for res in results:
        assert res["best"] == (float(flat.min()), float(np.argmin(flat)))


@pytest.mark.parametrize("top_k", TOP_KS)
def test_collective_constant_opt_matches_unsharded(primitives, top_k):
    import jax.numpy as jnp

    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu.ops.constant_opt import make_constant_optimiser as jax_optimiser

    rng = np.random.default_rng(7)
    const = rng.normal(size=(ISLANDS, POP, TREES, NODES)).astype(np.float32)
    flat_fit = rng.uniform(size=(ISLANDS, POP)).astype(np.float32).reshape(-1)
    flat_const = const.reshape(-1, TREES, NODES)
    k_eff = min(top_k, ISLANDS * POP)
    order = np.argsort(flat_fit, kind="stable")[:k_eff]
    sel = JaxTrees(jnp.ones((k_eff, TREES, NODES), jnp.int32), jnp.full((k_eff, TREES, NODES), -1),
                   jnp.full((k_eff, TREES, NODES), -1), jnp.asarray(flat_const[order]))
    optimise = jax_optimiser(lambda pop, data=None: jnp.sum(jnp.square(pop.const - TARGET), axis=(-1, -2)),
                             gradient_steps=4)
    ref_fit, ref_cands = optimise(sel, None)
    want_fit, want_const = flat_fit.copy(), flat_const.copy()
    want_fit[order] = np.asarray(ref_fit)
    want_const[order] = np.asarray(ref_cands.const)
    for res in primitives[3]:
        got_const, got_fit = res[f"constopt_{top_k}"]
        np.testing.assert_allclose(got_fit.numpy().reshape(-1), want_fit, rtol=1e-5)
        np.testing.assert_allclose(got_const.numpy().reshape(-1, TREES, NODES), want_const, rtol=1e-5)


def test_sharded_evaluation_equals_unsharded(primitives):
    sr_pop, data = _sr_case()
    want = SREvaluator(_fset(), substeps=1).evaluate_population(
        sr_pop.map(lambda x: x.reshape((-1,) + x.shape[2:])), data)
    for res in primitives[3]:
        assert torch.equal(res["sr_fitness"].reshape(-1), want)
        assert torch.equal(res["sr_fitness_flat"], want)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_fit")
    return _spawn(_fits, 2, tmp, str(tmp))


def test_sharded_fit_resumed_equals_uninterrupted(fits):
    for res in fits:
        assert res["killed"] and not res["ck15_exists"] and res["resume_equal"]
    assert torch.equal(fits[0]["sharded_best"], fits[1]["sharded_best"])
    best = fits[0]["sharded_best"]
    assert bool((best[1:] <= best[:-1]).all()), best


def test_sharded_fit_three_islands_equals_fit(fits):
    assert all(res["three_equal"] for res in fits)


def test_sharded_fit_adaptive_method(fits):
    for res in fits:
        a = res["adaptive"]
        assert a["sols"] == (4, 2, 16) and a["pops"] == (4, 16, 2, 16)
        assert a["fitness"].shape == (4, 16) and bool(torch.isfinite(a["fitness"]).all())
        assert bool(torch.isfinite(a["best"]).all()) and bool((a["best"][1:] <= a["best"][:-1]).all())
    assert torch.equal(fits[0]["adaptive"]["best"], fits[1]["adaptive"]["best"])


@pytest.fixture
def one_rank():
    mesh = pm.make_mesh(device="cpu")  # a one-rank gloo group in this process
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "non_fused"])
def test_fit_shard_one_rank_equals_fit(one_rank, fused):
    data = _vdp_data()
    want = _run(_gp(fused_reproduction=fused), data)
    gp = _gp(fused_reproduction=fused, mesh=one_rank)
    got = _run(gp, data, shard=True)
    assert one_rank.size == 1 and gp.device == torch.device("cpu")
    assert all(torch.equal(a, b) for a, b in zip(_flat(want), _flat(got)))


def test_mesh_accepted_and_conflicting_device_raises(one_rank):
    assert pm.mesh_axes(one_rank) == "i" and pm.island_sharding(one_rank, 4) == slice(0, 4)
    with pytest.raises(ValueError):
        pm.make_mesh(num_devices=2)
    gp = GeneticProgramming(num_generations=1, population_size=4, fitness_function=SREvaluator(),
                            operator_list=OPS, variable_list=[["x0", "x1"]], layer_sizes=[2],
                            mesh=one_rank)
    assert gp.mesh is one_rank and gp.device == torch.device("cpu")
    with pytest.raises(ValueError):
        GeneticProgramming(num_generations=1, population_size=4, fitness_function=SREvaluator(),
                           operator_list=OPS, variable_list=[["x0", "x1"]], layer_sizes=[2],
                           mesh=one_rank, device="cuda")


def _card_fits(rank, world):
    """``fit(shard=True)`` on this rank's card (NCCL): 4 islands x 64, with
    constant optimisation and migration; at W = 1 also ``fit()``."""
    mesh = pm.make_mesh()
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(0)
    data = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 2.0, 0.2, device=dev),
                            batch_size=4)

    def gp(**kwargs):
        return GeneticProgramming(
            num_generations=15, population_size=64, num_populations=4,
            fitness_function=SREvaluator(substeps=1), operator_list=OPS,
            variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16, max_init_depth=3,
            elite_percentage=0.25, coefficient_optimisation=True, gradient_steps=2,
            coefficient_opt_top_k=8, migration_period=5, **kwargs)

    run = lambda model: model.fit(torch.Generator(device=dev).manual_seed(1), data, shard=model.mesh is not None)
    got = gp(mesh=mesh)
    out = dict(got=[t.cpu() for t in _flat(run(got))], device=str(got.device))
    if world == 1:
        out["want"] = [t.cpu() for t in _flat(run(gp(device=dev)))]
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels and NCCL)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fit_shard_nccl_on_card(cuda, tmp_path):
    """NCCL ranks, one card each (2 where the machine has two, else 1): the
    histories agree across ranks, the best never grows, the fitness is
    finite; at W = 1 the run equals ``fit()`` on the card bit for bit."""
    world = min(torch.cuda.device_count(), 2)
    results = _spawn(_card_fits, world, tmp_path, backend="nccl")
    for rank, res in enumerate(results):
        best, fitness = res["got"][0], res["got"][-1]
        assert res["device"] == f"cuda:{rank}"
        assert fitness.shape == (4, 64) and bool(torch.isfinite(fitness).all())
        assert bool((best[1:] <= best[:-1]).all()), best
        assert all(torch.equal(a, b) for a, b in zip(res["got"], results[0]["got"]))
        if world == 1:
            assert all(torch.equal(a, b) for a, b in zip(res["got"], res["want"]))
