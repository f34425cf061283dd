"""PyTorch port: ``GeneticProgramming.fit`` with constant optimisation and
checkpoint/resume (CPU, tiny sizes: 2 islands x 16, N = 16, T = 10, B = 4).

* The constant-optimisation schedule of the reference (after generation 10,
  every 5th) fires at generations 14 and 19 of 20; the best fitness never
  increases (elitism, and refinement never hurts).
* A run killed during generation 10 and resumed from the checkpoint it wrote
  after generation 9 equals the uninterrupted run bit for bit: histories,
  final populations and final fitness.
* The same two checks on the non-fused reproduction path
  (``fused_reproduction=False``: the per-tree operators of
  ``ops/reproduction.make_evolve_island``).

``fit(shard=True)`` is held to ``fit()`` in ``test_torch_parallel.py``.
"""
import pytest
import torch

from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.core.trees import validate_host
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
from multitreegp_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
GENERATIONS = 20


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


def make_gp(evaluator=None, **kwargs):
    return GeneticProgramming(
        num_generations=GENERATIONS, population_size=16, num_populations=2,
        fitness_function=evaluator or KillingEvaluator(substeps=1), operator_list=OPS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16, max_init_depth=3,
        elite_percentage=0.25, coefficient_optimisation=True, gradient_steps=2,
        coefficient_opt_top_k=4, device="cpu", **kwargs,
    )


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(0)
    return generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 2.0, 0.2), batch_size=4)


def fit(gp, data, seed=1, **kwargs):
    return gp.fit(torch.Generator().manual_seed(seed), data, **kwargs)


def test_fit_schedules_constant_optimisation(data, **kwargs):
    gp = make_gp(**kwargs)
    rounds, refined = [], []
    optimise = gp._optimise

    def recording(cands, d):
        rounds.append(gp.current_generation)
        before = gp.evaluator.evaluate_population(cands, d)
        fit_, out = optimise(cands, d)
        refined.append(bool((fit_ <= before).all()))
        return fit_, out

    gp._optimise = recording
    best, sols, pops, fitness = fit(gp, data)
    assert rounds == [14, 19] and all(refined)
    assert best.shape == (GENERATIONS,) and sols.ops.shape == (GENERATIONS, 2, 16)
    assert torch.isfinite(best).all()
    assert bool((best[1:] <= best[:-1]).all()), best
    assert fitness.shape == (2, 16) and float(fitness.min()) == float(best[-1])
    validate_host(pops, gp.fset.slots())
    assert gp.current_generation == GENERATIONS


def test_fit_resumed_equals_uninterrupted(data, tmp_path, **kwargs):
    path = str(tmp_path / "ck_{gen}.npz")
    done = make_gp(**kwargs)
    want = fit(done, data, checkpoint_path=path, checkpoint_every=GENERATIONS)

    killed = make_gp(KillingEvaluator(kill_at=10, substeps=1), **kwargs)
    with pytest.raises(Killed):
        fit(killed, data, checkpoint_path=path, checkpoint_every=5)
    ck = load_checkpoint(path.format(gen=10))
    assert ck["generation"] == 10 and not (tmp_path / "ck_15.npz").exists()

    got = fit(make_gp(**kwargs), data, seed=99, resume_from=path.format(gen=10))  # the seed is not used
    for w, g in zip(want, got):
        for a, b in zip(*((w, g) if isinstance(w, tuple) else ((w,), (g,)))):
            assert torch.equal(a, b)

    # a completed run's checkpoint returns its state
    again = fit(make_gp(**kwargs), data, resume_from=path.format(gen=GENERATIONS))
    assert torch.equal(again[0], done.best_fitnesses) and torch.equal(again[2].ops, want[2].ops)


def test_fit_non_fused_schedules_constant_optimisation(data):
    test_fit_schedules_constant_optimisation(data, fused_reproduction=False)


def test_fit_non_fused_resumed_equals_uninterrupted(data, tmp_path):
    test_fit_resumed_equals_uninterrupted(data, tmp_path, fused_reproduction=False)
