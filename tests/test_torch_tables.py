"""Batched interpolation tables of waiwera_tpu_torch (StackedTables,
SparseTableUpdate, build_sparse_updates) against the JAX package's, on
the cases of tests/test_network.py (random tables of 1-6 knots, linear,
step and pchip, integrate and endpoint averaging), at rtol 1e-12."""

import numpy as np
import pytest
import torch

RTOL = 1e-12


def _tables(pkg, seed, variant, k, nmin, nmax, averaging=None):
    """k random one-column tables of the package `pkg` ("jax" or
    "torch"), from one numpy seed."""
    if pkg == "jax":
        from waiwera_tpu.utils.interpolation import InterpolationTable
    else:
        from waiwera_tpu_torch.utils.interpolation import InterpolationTable
    rng = np.random.RandomState(seed)
    out = []
    for i in range(k):
        n = rng.randint(nmin, nmax)
        x = np.sort(rng.uniform(0.0, 10.0, n))
        y = rng.uniform(-2.0, 2.0, (n, 1))
        avg = averaging or ("endpoint" if i % 3 == 2 else "integrate")
        out.append(InterpolationTable(np.concatenate([x[:, None], y], axis=1),
                                      interpolation=variant, averaging=avg))
    return out


def _stacks(seed, variant, k=7, nmin=1, nmax=6, averaging=None):
    from waiwera_tpu.utils.interpolation import StackedTables as JStack
    from waiwera_tpu_torch.utils.interpolation import StackedTables as TStack

    return (JStack(_tables("jax", seed, variant, k, nmin, nmax, averaging)),
            TStack(_tables("torch", seed, variant, k, nmin, nmax, averaging)))


@pytest.mark.parametrize("variant, seed, nmin", [
    ("linear", 0, 1), ("step", 1, 2), ("pchip", 1, 2),
], ids=["linear", "step", "pchip"])
def test_stacked_tables_match_jax(variant, seed, nmin):
    """Evaluation at one abscissa per table (inside and beyond the knots)
    and the average over an interval, per-row endpoint or integrate."""
    sj, st = _stacks(seed, variant, nmin=nmin)
    rng = np.random.RandomState(seed + 10)
    xi = rng.uniform(-1.0, 12.0, sj.k)
    np.testing.assert_allclose(st(torch.as_tensor(xi)).numpy(),
                               np.asarray(sj(xi)), rtol=RTOL, atol=1e-14)
    for a, b in ((1.3, 8.6), (2.0, 7.0), (-3.0, 15.0), (4.0, 4.0)):
        got = st.average(torch.tensor(a, dtype=torch.float64),
                         torch.tensor(b, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, np.asarray(sj.average(a, b)),
                                   rtol=RTOL, atol=1e-14,
                                   err_msg=f"[{a}, {b}]")


def test_stacked_tables_match_single():
    """tests/test_network.py:22: a stack reproduces each of its tables
    evaluated alone (the port's InterpolationTable)."""
    from waiwera_tpu_torch.utils.interpolation import StackedTables

    tables = _tables("torch", 0, "linear", 7, 1, 6, averaging="integrate")
    stack = StackedTables(tables)
    xi = torch.as_tensor(np.random.RandomState(3).uniform(-1.0, 12.0, 7))
    single = torch.stack([t(xi[i]) for i, t in enumerate(tables)])
    torch.testing.assert_close(stack(xi), single, rtol=1e-10, atol=1e-12)
    a = torch.tensor(1.3, dtype=torch.float64)
    b = torch.tensor(8.6, dtype=torch.float64)
    single = torch.stack([t.average(a, b) for t in tables])
    torch.testing.assert_close(stack.average(a, b), single, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("variant", ["linear", "pchip"])
def test_sparse_updates_match_jax(variant):
    """build_sparse_updates groups tables by variant; average_into and
    eval_into replace the covered rows of a base array and keep the
    rest, as the JAX package's do."""
    import jax.numpy as jnp
    from waiwera_tpu.utils.interpolation import (
        build_sparse_updates as jbuild,
    )
    from waiwera_tpu_torch.utils.interpolation import (
        build_sparse_updates as tbuild,
    )

    tj = _tables("jax", 5, variant, 4, 2, 6)
    tt = _tables("torch", 5, variant, 4, 2, 6)
    step_j = _tables("jax", 6, "step", 2, 2, 5)
    step_t = _tables("torch", 6, "step", 2, 2, 5)
    idx = [1, 4, 6, 9, 2, 7]
    uj = jbuild(list(zip(idx, tj + step_j)) + [(0, None)])
    ut = tbuild(list(zip(idx, tt + step_t)) + [(0, None)])
    assert len(uj) == len(ut) == 2
    base = np.linspace(-1.0, 1.0, 10)
    xi = np.random.RandomState(8).uniform(0.0, 10.0, 10)
    for j, t in zip(uj, ut):
        np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
        got = t.average_into(torch.as_tensor(base), 1.5, 6.5).numpy()
        np.testing.assert_allclose(got, np.asarray(j.average_into(
            jnp.asarray(base), 1.5, 6.5)), rtol=RTOL, atol=1e-14)
        got = t.eval_into(torch.as_tensor(base), torch.as_tensor(xi)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(j.eval_into(jnp.asarray(base), jnp.asarray(xi))),
            rtol=RTOL, atol=1e-14)


def test_stacked_tables_follow_dtype():
    """A stack evaluates in the dtype of its input (an f32 tangent
    chain stays f32) and refuses tables of mixed variants."""
    from waiwera_tpu_torch.utils.interpolation import StackedTables

    _, st = _stacks(2, "linear", k=3, nmin=2)
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float32)
    assert st(x).dtype == torch.float32
    assert st.average(x[0], x[1]).dtype == torch.float32
    mixed = _tables("torch", 0, "linear", 1, 2, 3) + _tables(
        "torch", 0, "step", 1, 2, 3)
    with pytest.raises(ValueError, match="share interpolation"):
        StackedTables(mixed)
