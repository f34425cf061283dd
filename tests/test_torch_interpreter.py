"""PyTorch port: the plain interpreter against JAX ``evaluate_trees(impl="ladder")``.

Same JAX-sampled trees (with hand-set constants near zero so that ``/``
produces inf/nan lanes) and the same numpy data go through both. Tolerance:
finite lanes rtol 1e-6 — both run the same float32 operations per row, and
the only freedom is how each backend rounds a division or sine; the
non-finite masks must be identical.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core.interpreter import evaluate_trees, make_candidate_evaluator

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.4), ("sin", jnp.sin, 1, 0.3)]


def test_interpreter_matches_jax_ladder():
    jf = jax_function_set(OPS, [["x0", "x1", "x2"]], [2])
    pop = jax_sampler(jf, 4, 16)(jr.PRNGKey(3), 64)
    arrays = [np.asarray(a).copy() for a in pop]
    const = arrays[3]
    const[::5] = np.where(arrays[0][::5] == 1, 0.0, const[::5])  # zero divisors -> inf/nan
    rng = np.random.default_rng(0)
    data = rng.normal(size=(64, 1, 3)).astype(np.float32) * 3
    jpop = pop._replace(const=jnp.asarray(const))
    ref = np.asarray(jax_evaluate(jpop, jnp.asarray(data), jf, impl="ladder"))
    got = evaluate_trees(trees_from_numpy(*arrays), torch.from_numpy(data), function_set_from_jax(jf)).numpy()
    assert got.shape == ref.shape == (64, 2)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert (~fin).any(), "the case should include non-finite lanes"
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_candidate_evaluator_broadcasts_one_vector():
    jf = jax_function_set(OPS[:4], [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(4), 4)
    tf = function_set_from_jax(jf)
    cand = trees_from_numpy(*[np.asarray(a)[0] for a in pop])
    x = torch.tensor([0.3, -1.2])
    out = make_candidate_evaluator(tf)(cand, x)
    ref = np.asarray(jax_evaluate(pop[0], jnp.asarray([[0.3, -1.2]]), jf, impl="ladder"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
