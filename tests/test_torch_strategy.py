"""PyTorch port: the slice as a whole (CPU).

* ``GeneticProgramming.evaluate_population`` of the port equals the JAX
  package's on the same initial populations (converted from JAX) and the same
  data: clamped candidates exactly; elsewhere median relative error <= 1e-6,
  90% of candidates within 1e-4 and the ranking preserved (Spearman >= 0.999,
  the repo's criterion for rollouts that cannot match bit for bit).
  XLA:CPU fuses the RK updates into FMAs and the port does not, and on the
  odd chaotic trajectory the ulps grow to ~3e-3 relative within 10 steps.
* A tiny host loop (2 islands x 16, N = 16, T = 10) runs three generations
  with elitism, so the best fitness never increases, and renders its best.
* ``import multitreegp_tpu_torch`` never imports JAX.
"""
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu import GeneticProgramming as JaxGP
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core.trees import validate_host
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data

torch.set_num_threads(1)

JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("/", jnp.divide, 2, 0.1)]
OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
COMMON = dict(num_generations=3, population_size=16, variable_list=[["x0", "x1"]], layer_sizes=[2],
              num_populations=2, max_nodes=16, max_init_depth=3, size_parsimony=0.01)


def test_evaluate_population_matches_jax():
    ts = jnp.arange(0.0, 2.0, 0.2)
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), ts, batch_size=4, substeps=8)
    jgp = JaxGP(fitness_function=JaxSREvaluator(substeps=1, interpreter="ladder"),
                operator_list=JAX_OPS, **COMMON)
    pops = jgp.initialize_population(jr.PRNGKey(1))
    ref, _ = jgp.evaluate_population(pops, data)

    gp = GeneticProgramming(fitness_function=SREvaluator(substeps=1), operator_list=JAX_OPS,
                            device="cpu", **COMMON)
    fit, out = gp.evaluate_population(trees_from_numpy(*[np.asarray(a) for a in pops]),
                                      sr_data_from_numpy(*data[:3]))
    ref = np.asarray(ref)
    got = fit.numpy()
    assert got.shape == ref.shape == (2, 16)
    clamped = ref >= 1e5
    np.testing.assert_array_equal(got >= 1e5, clamped)
    rel = np.abs(got - ref)[~clamped] / np.abs(ref)[~clamped]
    assert np.median(rel) <= 1e-6 and np.quantile(rel, 0.9) <= 1e-4, rel
    ranks = lambda a: np.argsort(np.argsort(a))
    spearman = np.corrcoef(ranks(got[~clamped]), ranks(ref[~clamped]))[0, 1]
    assert spearman >= 0.999, spearman
    assert float(gp.best_fitnesses[0]) == got.min()


def test_host_loop_improves_and_renders():
    g = torch.Generator().manual_seed(0)
    data = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 2.0, 0.2), batch_size=4)
    gp = GeneticProgramming(fitness_function=SREvaluator(substeps=1), operator_list=OPS,
                            elite_percentage=0.25, device="cpu", **COMMON)
    assert gp.elite_size == 4
    pops = gp.initialize_population(g)
    best = []
    for _ in range(3):
        fitness, pops = gp.evaluate_population(pops, data)
        assert torch.isfinite(fitness).all() and fitness.shape == (2, 16)
        best.append(float(fitness.min()))
        pops = gp.evolve(pops, fitness, g)
        validate_host(pops, gp.fset.slots())
    assert best[1] <= best[0] and best[2] <= best[1]
    assert gp.current_generation == 3
    fits, sols = gp.get_statistics()
    assert fits.shape == (3,) and sols.ops.shape == (3, 2, 16)
    text = gp.to_string(gp.get_statistics(2)[1])
    assert text.startswith("[") and "x" in text
    out = gp.tree_evaluator(sols[2], torch.tensor([0.5, -0.5]))
    assert out.shape == (2,)


def test_constructor_surface():
    base = dict(COMMON, fitness_function=SREvaluator(), operator_list=OPS, device="cpu")
    gp = GeneticProgramming(**dict(base, size_parsimony=0.0), size_parsinomy=0.5)
    assert gp.size_parsimony == 0.5
    gp = GeneticProgramming(**dict(base, population_size=512), elite_percentage=0.1)
    assert gp.elite_size == 50 and gp.migration_size == 51
    # mesh=: a rank's device is the mesh's, and a conflicting device= raises
    mesh = SimpleNamespace(device=torch.device("cpu"), size=1, rank=0)
    assert GeneticProgramming(**dict(base, device=None), mesh=mesh).device == torch.device("cpu")
    assert GeneticProgramming(**base, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh"):
        GeneticProgramming(**dict(base, device="cuda"), mesh=mesh)
    # JAX's routing: fused_reproduction=False builds the per-tree operators'
    # path; True past the reproduction kernel's 256 rows raises
    assert not GeneticProgramming(**base, fused_reproduction=False).fused_reproduction
    assert GeneticProgramming(**base).fused_reproduction
    with pytest.raises(NotImplementedError, match="256"):
        GeneticProgramming(**dict(base, max_nodes=300), fused_reproduction=True)
    with pytest.raises(TypeError):
        GeneticProgramming(**base, no_such_option=1)
    with pytest.raises(ValueError):
        GeneticProgramming(**dict(base, population_size=15))
    gp = GeneticProgramming(**base, coefficient_optimisation=True, coefficient_opt_top_k=100)
    assert gp.coefficient_optimisation and gp.coefficient_opt_top_k == 32 and gp.gradient_steps == 10
    assert [g for g in range(20) if gp._optimise_due(g)] == [14, 19]
    assert gp.mesh is None  # fit(shard=True) makes a one-rank mesh on first use
    cand = gp.initialize_population(torch.Generator().manual_seed(0))[0, 0]
    f = gp.to_callable(cand)
    x = torch.tensor([[0.5, -0.5], [1.0, 2.0], [0.0, 3.0]])
    out = f(x)
    assert out.shape == (3, 2)
    torch.testing.assert_close(out[1], gp.tree_evaluator(cand, x[1]), rtol=0, atol=0)


def test_impl_keyword_matches_jax_surface():
    """``evaluate_trees(..., impl=)`` and ``to_callable(candidate, impl=)``
    take JAX's keyword with its default and its four values (each the same
    interpreter on one device); any other value raises ``ValueError``."""
    import inspect

    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate_trees
    from multitreegp_tpu_torch.core.interpreter import IMPLS, evaluate_trees

    for port_fn, jax_fn in ((evaluate_trees, jax_evaluate_trees),
                            (GeneticProgramming.to_callable, JaxGP.to_callable)):
        assert (inspect.signature(port_fn).parameters["impl"].default
                == inspect.signature(jax_fn).parameters["impl"].default == "auto")
    assert IMPLS == ("auto", "pallas", "ladder", "gather")
    gp = GeneticProgramming(fitness_function=SREvaluator(), operator_list=OPS, device="cpu", **COMMON)
    cand = gp.initialize_population(torch.Generator().manual_seed(0))[0, 0]
    x = torch.tensor([[0.5, -0.5], [1.0, 2.0]])
    outs = [gp.to_callable(cand, impl=impl)(x) for impl in IMPLS]
    assert all(torch.equal(o, outs[0]) for o in outs)
    for bad in ("unrolled", "Pallas", None):
        with pytest.raises(ValueError):
            gp.to_callable(cand, impl=bad)
        with pytest.raises(ValueError):
            evaluate_trees(cand, x[:, None, :], gp.fset, impl=bad)


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """``chip_smoke.run`` at a tiny size on CPU tensors, where every wrapper
    takes its plain version: the phases' control flow and checks hold (the
    fixed instances' rows cut to 256, so phase 19's 300 rows take the wide
    instance's cases)."""
    import chip_smoke
    from multitreegp_tpu_torch.core import cuda_interpreter as ci

    monkeypatch.setattr(ci, "FIXED_ROWS", 256)

    tiny = dict(islands=2, pop=16, max_nodes=16, depth=3, batch=4, horizon=1.0, dt=0.2,
                generations=2, timing_runs=1, plain_runs=1,
                fit_generations=20, top_k=4, gradient_steps=2, elite=0.25, interp_runs=1,
                adaptive_budget=40, adaptive_check_budget=40, adaptive_interval_steps=8, adaptive_short_t=3,
                adaptive_opt_steps=2,
                policy_horizon=1.0, policy_nodes=16, policy_substeps=2, policy_adaptive_substeps=8,
                policy_fixed_t=4, policy_adaptive_t=3, legs_pop=8, legs_t=3, trig_adaptive_t=3,
                policy_opt_top_k=4, policy_opt_steps=2, policy_opt_t=4,
                noise=0.05, noisy_adaptive_t=3, ab_runs=1, probe_reps=2,
                deep_nodes=64, deep_depth=5, deep_pop=8, deep_t=3, deep_rep_pop=16, deep_policy_t=3,
                deep_adaptive_t=3, deep_adaptive_budget=40, deep_interval_steps=8,
                wide_nodes=300, wide_depth=5, wide_generations=2, wide_check_nodes=(300,),
                lorenz_states=40, lorenz_forcing=8.0, lorenz_depth=2, lorenz_dt=0.05, ext_chain_nodes=300,
                wide_batch=1100, wide_check_t=3, wide_check_budget=8, wide_check_interval_steps=4,
                deep_gen_nodes=64, wide_policy_states=3, wide_policy_generations=2, wide_policy_check_t=3,
                wide_policy_pop=2, wide_policy_runs=1, wide_policy_exact_dt=0.25,
                deep_gen_depth=5, chain_k=2, shard_generations=15,
                user_env_t=5, user_env_dt=0.05, user_env_generations=2, user_env_check_t=3, user_env_wide_states=3,
                user_env_acrobot_t=3, user_env_runs=1,
                example_sizes=dict(generations=2, population=20, islands=2), example_t=3,
                example_check_t=3, example_check_adaptive_t=3, example_check_budget=40)
    out = chip_smoke.run(torch.device("cpu"), tiny)
    assert out["fitness"]["bit_equal"] and out["reproduce"]["ops_identical"] == 1.0
    deep = out["deep"]
    assert all(v["identical"] == 1.0 for v in deep["fitness"].values())
    assert deep["rollout"]["identical"] == 1.0 and deep["rollout"]["lanes"] == 8 * 4
    inspection = out["adaptive_path"]["inspection"]
    assert inspection["identical"] == 1.0 and inspection["lanes"] == 4 and inspection["bound_ms"] > 0
    assert all(v["identical"] == 1.0 and v["lanes"] == 8 * 4 for v in deep["adaptive"].values())
    assert deep["reproduce"]["ops_identical"] == 1.0 and deep["reproduce"]["lanes"] == 16
    for kind, policies in (("policy_fixed", "dynamic"), ("policy_adaptive", "static")):
        r = deep[kind]
        assert r["identical"] == 1.0 and r["lanes"] == 8 * 4 and r["policies"] == policies
    wide_rows = ["sr_fitness_wide", "sr_rollout_wide", "sr_adaptive_global_wide", "sr_adaptive_interval_wide"]
    policy_wide_rows = ["policy_wide", "policy_adaptive_wide"]
    user_env_rows = ["policy_user_env", "policy_adaptive_user_env"]
    assert [k["name"] for k in out["kernels"]] == [
        "sr_fitness", "reproduce", "interpret_fwd", "interpret_bwd", "sr_adaptive_global",
        "sr_adaptive_interval", "sr_rollout", "policy", "policy_adaptive", *wide_rows, *policy_wide_rows,
        *user_env_rows, "branch_probe"]
    tree_rows = out["kernels"][:-9]  # the fixed instances' rows: phases 24 and 25 add to each
    pk = out["policy_kernels"]
    assert {"fixed_static", "fixed_dynamic", "adaptive_static", "adaptive_dynamic"} <= set(pk)
    assert all(pk[k]["identical"] == 1.0 for k in ("fixed_static", "adaptive_dynamic"))
    assert len(pk["legs"]) == 16 and all(r["identical"] == 1.0 for r in pk["legs"])
    assert pk["trig"]["interpreter"]["vjp_bit_equal"] and pk["trig"]["unary_rows"] > 0
    assert set(pk["trig"]["reproduce"]) == {"static", "dynamic"}
    path = out["policy_path"]
    assert all(len(path[k]["generations"]) == 2 for k in ("static", "dynamic", "adaptive"))
    assert path["optimise"]["refined_sum"] <= path["optimise"]["unrefined_sum"]
    assert path["adaptive"]["steps_max"] <= 8 * 4
    assert set(out["adaptive_kernels"]) == {"global_t3", "global_t5", "interval_t3", "rollout"}
    assert all(v["identical"] == 1.0 for v in out["adaptive_kernels"].values())
    g5 = out["adaptive_kernels"]["global_t5"]  # 32 candidates x 4 trajectories: 4 warps
    assert g5["warps"] == 4 and g5["warp_steps_max"] == g5["steps_max"] <= 40
    assert g5["warp_steps_min"] >= g5["steps_min"] and 0 <= g5["warps_at_budget"] <= 4
    path = out["adaptive_path"]
    assert len(path["generations"]) == 2 and path["refined_sum"] <= path["unrefined_sum"]
    assert set(path["telemetry"]) == {"global", "interval"} and path["telemetry"]["global"]["max"] <= 40
    assert set(path["optimise_split_ms"]) == {"forward", "recompute", "backward"}
    assert out["kernels"][2]["population"]["bound_ms"] > 0
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) and k["bound_ms"] > 0 for k in out["kernels"])
    assert len(out["main_path"]["generations"]) == 2
    for shape, lanes in (("recompute", 4 * 4 * 2), ("population", 32 * 4 * 2)):
        assert out["interpreter"][shape]["lanes"] == lanes
        assert all(out["interpreter"][shape]["bit_equal"].values())
        assert all(out["interpreter"][shape]["bit_equal_grouped"].values())
    assert deep["interpreter"]["lanes"] == 8 * 4 * 2 and all(deep["interpreter"]["bit_equal"].values())
    ext = out["extended"]  # phase 24: the extended operator sets
    assert len(ext["generations"]) == 2 and len(ext["policy"]["generations"]) == 2
    assert ext["round"]["refined_sum"] <= ext["round"]["unrefined_sum"]
    assert set(ext["checks"]) == {"sr_fitness", "sr_rollout", "sr_adaptive_global", "sr_adaptive_interval",
                                  "policy_static", "policy_dynamic", "policy_adaptive_static",
                                  "interpreter_n64", "interpreter_n300", "interpreter_round", "reproduce"}
    assert all(c.get("identical", 1.0) == 1.0 for c in ext["checks"].values())
    assert all(all(ext["checks"][k]["bit_equal"].values())
               for k in ("interpreter_n64", "interpreter_n300", "interpreter_round"))
    assert ext["checks"]["interpreter_round"]["lanes"] == 4 * 4 * 2
    assert ext["checks"]["reproduce"]["ops_identical"] == 1.0
    ext_checks = {k["name"]: set(k["extended"]["checks"]) for k in tree_rows}
    assert "interpreter_round" in ext_checks["interpret_fwd"] and ext_checks["reproduce"] == {"reproduce"}
    assert all("extended" in k for k in tree_rows)
    user = out["user"]  # phase 25: gplearn's protected operators as user operators
    assert len(user["generations"]) == 2 and len(user["policy"]["generations"]) == 2
    assert user["round"]["refined_sum"] <= user["round"]["unrefined_sum"] and user["user_rows"] > 0
    assert set(user["checks"]) == {"sr_fitness", "sr_rollout", "sr_adaptive_global", "sr_adaptive_interval",
                                   "policy_static", "policy_dynamic", "policy_adaptive_static",
                                   "interpreter_round", "reproduce"}
    assert all(c.get("identical", 1.0) == 1.0 for c in user["checks"].values())
    assert all(user["checks"]["interpreter_round"]["bit_equal"].values())
    assert user["checks"]["reproduce"]["ops_identical"] == 1.0
    assert all("user" in k for k in tree_rows)
    sde = out["sde"]
    assert sde["rows"]["bits_equal"] and max(sde["rows"]["ulp_gap"].values()) == 0
    assert sde["fitness_kicks"]["identical"] == 1.0 and out["kernels"][0]["kicks"]["lanes"] == 32 * 4
    assert all(len(sde[k]["generations"]) == 2 for k in ("sr_loop", "static_loop", "dynamic_loop"))
    assert sde["noisy_adaptive"]["t_steps"] == 3
    probe = out["probe"]["modes"]
    assert set(probe) == {"always", "when", "dynfori", "dynval", "lane"}
    assert [probe[m]["iterations_mean"] for m in ("always", "when", "dynfori")] == [64, 9, 12]
    rounds = out["const_opt"]["rounds"]
    assert [r["generation"] for r in rounds] == [14, 19]
    assert all(r["refined_sum"] <= r["unrefined_sum"] for r in rounds)
    assert len(out["const_opt"]["generation_ms"]) == 20 and out["const_opt"]["drift_calls"] == 16
    assert set(rounds[0]["split_ms"]) == {"forward", "recompute", "backward"}
    nf = out["non_fused"]
    assert all(len(nf[k]["generations"]) == 2 for k in ("non_fused", "fused"))
    wide = out["wide"]
    assert len(wide["generations"]) == 2 and wide["round"]["refined_sum"] <= wide["round"]["unrefined_sum"]
    assert set(wide["checks"]) == {"n300_recompute", "n300_one_member", "n300_recompute_roots",
                                   "n300_one_member_roots", "n300_population", "n300_round"}
    assert all(all(c["bit_equal"].values()) for c in wide["checks"].values())
    assert wide["checks"]["n300_one_member"]["lanes"] == 4 * 2
    assert wide["checks"]["n300_population"]["lanes"] == 32 * 4 * 2
    assert wide["checks"]["n300_recompute_roots"]["rows_max"] == 299
    assert wide["checks"]["n300_recompute_roots"]["c2_max"] == 297
    assert set(wide["checks"]["n300_recompute_roots"]["bit_equal"]) == {"fwd"}
    assert out["kernels"][2]["wide"]["n"] == 300 and len(out["gen_deep"]["generations"]) == 2
    lorenz, ops33 = out["lorenz96"], out["ops33"]  # phase 27
    assert lorenz["states"] == 40 and len(lorenz["generations"]) == 2
    assert lorenz["round"]["refined_sum"] <= lorenz["round"]["unrefined_sum"]
    assert lorenz["checks"]["population"]["lanes"] == 32 * 4 * 40
    assert ops33["round"]["refined_sum"] <= ops33["round"]["unrefined_sum"] and ops33["user_rows"] > 0
    assert ops33["device_op_ids"] == list(range(33))
    assert all(all(c["bit_equal"].values()) for r in (lorenz, ops33) for c in r["checks"].values())
    assert set(out["kernels"][3]["wide"]["ops33"]["checks"]) == {"round"}
    ws = lorenz["wide_state"]  # phase 27: the SR kernels' wide-state instances
    assert ws["fused_vs_general"]["clamp_agreement"] >= 0.999 and ws["fused_vs_general"]["spearman"] >= 0.997
    assert all(ws["kernels"][k]["check"]["identical"] == 1.0 and ws["kernels"][k]["check"]["lanes"] == 32 * 4
               for k in wide_rows)
    assert out["trajectories"]["identical"] == 1.0 and out["trajectories"]["lanes"] == 32 * 1100
    assert all(k["bound_ms"] > 0 and k["launches"] is not None for k in out["kernels"][-9:-1])
    wp = out["wide_policy"]  # phase 28: the policy kernels' wide-state instances
    assert len(wp["generations"]) == 2 and wp["fused_vs_general"]["exact_grid"]["spearman"] >= 0.997
    assert all(wp["kernels"][k]["check"]["identical"] == 1.0 and wp["kernels"][k]["check"]["lanes"] == 32 * 4
               and wp["kernels"][k]["three_targets"]["identical"] == 1.0 for k in policy_wide_rows)
    assert wp["trajectories"]["check"]["identical"] == 1.0 and wp["trajectories"]["check"]["lanes"] == 2 * 1100
    assert out["kernels"][7]["trajectories"]["trajectories"] == 1100
    ue = out["user_env"]  # phase 29: user environments through #6/#7
    assert len(ue["generations"]) == 2 and ue["fused_vs_general"]["clamp_agreement"] >= 0.999
    assert set(ue["checks"]) == {"fixed_static", "fixed_dynamic", "adaptive_static", "fixed_noisy",
                                 "wide_fixed", "wide_adaptive"}
    assert all(c["identical"] == 1.0 for c in ue["checks"].values())
    assert ue["checks"]["fixed_static"]["lanes"] == 32 * 4 and ue["checks"]["wide_fixed"]["lanes"] == 8 * 4
    assert set(ue["paths"]) == {"dynamic", "adaptive", "noisy"}
    assert ue["traced_acrobot"]["bit_equal"] == {"fixed": 1.0, "adaptive": 1.0}
    assert ue["traced_acrobot"]["library"].startswith("policy_e")
    assert out["kernels"][-3]["library"].startswith("policy_e")
    chained = out["chained"]
    assert all(chained[k]["identical"] == 1.0 and chained[k]["candidates"] == 32 for k in ("ode", "sde"))
    sharded = out["sharded"]
    assert sharded["world"] == 1 and sharded["backend"] == "gloo" and len(sharded["ranks"]) == 1
    rank = sharded["ranks"][0]
    assert rank["round"]["generation"] == 14 and rank["ring_generations"] == [9]
    assert len(rank["best"]) == 15 and out["kernels"][0]["launches_sharded"] == [0]
    examples = out["examples"]
    assert [(r["label"], r["seed"]) for r in examples["runs"]] == [
        ("sr", 0), ("sr", 1), ("sr", 2), ("sr_fused", 0), ("sr_adaptive", 0), ("static", 0),
        ("static", 1), ("static", 2), ("static_adaptive", 0), ("dynamic", 0), ("dynamic", 1),
        ("dynamic", 2)]
    assert all(r["generations"] == 2 and r["candidates"] == 40 for r in examples["runs"])
    checks = examples["checks"]
    assert set(checks) == {"sr_fitness", "reproduce", "sr_adaptive_global", "policy", "policy_adaptive"}
    assert set(checks["policy"]) == {"static", "dynamic"}
    assert checks["reproduce"]["sr"]["ops_identical"] == 1.0
    assert all(c.get("identical", 1.0) == 1.0 for by_run in checks.values() for c in by_run.values())


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import multitreegp_tpu_torch, multitreegp_tpu_torch.convert, chip_smoke\n"
        "import multitreegp_tpu_torch.models.evaluators, multitreegp_tpu_torch.utils.metrics\n"
        "import multitreegp_tpu_torch.ops.constant_opt, multitreegp_tpu_torch.ops.optim\n"
        "import multitreegp_tpu_torch.utils.checkpoint, multitreegp_tpu_torch.core.cuda_interpreter\n"
        "import multitreegp_tpu_torch.core.cuda_adaptive, multitreegp_tpu_torch.core.cuda_rollout\n"
        "import multitreegp_tpu_torch.core.cuda_policy, multitreegp_tpu_torch.models.environments\n"
        "import multitreegp_tpu_torch.core.prng, multitreegp_tpu_torch.models.evaluators.noise\n"
        "import multitreegp_tpu_torch.tools.branch_probe, multitreegp_tpu_torch.ops.mutation\n"
        "import multitreegp_tpu_torch.ops.splice, multitreegp_tpu_torch.ops.reproduction\n"
        "import multitreegp_tpu_torch.parallel.mesh, multitreegp_tpu_torch.parallel.collective\n"
        "import multitreegp_tpu_torch.tools.inline_drift, multitreegp_tpu_torch.utils.profiling\n"
        "import multitreegp_tpu_torch.examples.symbolic_regression\n"
        "import multitreegp_tpu_torch.examples.static_policy, multitreegp_tpu_torch.examples.dynamic_policy\n"
        "import multitreegp_tpu_torch.core.user_envs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'multitreegp_tpu.'))]\n"
        "assert not bad and 'multitreegp_tpu' not in sys.modules, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
