"""Record the JAX package's float32 run of one lane of the grid setting
``zdt2-n10-rbf_cubic-steepest_descent-s8`` trip by trip, into
``tests/golden/zdt2_n10_rbf_cubic_f32_lane1.npz``.

The setting's second Halton start (lane 1), at the reference budget
(``parallel/benchmarks.py::_default_config``), holds one site twice in its
database from iteration 4 on. JAX's jit of this float32 solve takes minutes
on a CPU, so ``tests/test_torch_zdt2_f32.py`` steps the port from these
recorded states instead of running JAX. The file holds, for every trip
``t`` from the initial state (0) to the stop, each leaf of the state under
``state_to_numpy``'s names as ``"<t>/<leaf>"``, with the lane axis (B=1)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_record_zdt2_f32.py

With ``--port-states TAG=FILE ...`` it records instead the JAX package's
trip from each state of the port that ``morbit_tpu_torch.tools.nan_fit_states``
saved before a lane's first non-finite fit (on the CPU or on the card), into
``tests/golden/zdt2_n10_rbf_cubic_f32_nan_fits.npz``: for each lane ``i`` of
each file, ``"<TAG>_lane<i>/before/<leaf>"``, the port's state after the trip
as ``"<TAG>_lane<i>/port_after/<leaf>"`` and JAX's as
``"<TAG>_lane<i>/jax_after/<leaf>"``::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_record_zdt2_f32.py \
        --port-states cpu=nan_fit_states_cpu.npz card=nan_fit_states_cuda.npz
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import morbit_tpu.parallel.benchmarks as jb  # noqa: E402
from morbit_tpu.parallel.multistart import build_solver  # noqa: E402
from morbit_tpu.problems.synthetic import halton_starts  # noqa: E402

SETTING = ("zdt2", 10, "rbf_cubic", "steepest_descent", 8)
LANE = 1
PATH = os.path.join(os.path.dirname(__file__), "golden", "zdt2_n10_rbf_cubic_f32_lane1.npz")
NAN_FITS_PATH = os.path.join(os.path.dirname(__file__), "golden",
                             "zdt2_n10_rbf_cubic_f32_nan_fits.npz")
#: the leaves of a JAX RBF state of one group in ``jax.tree_util`` order,
#: under ``state_to_numpy``'s names; the PRNG key, last, is not among them
_JAX_ORDER = ("x", "x_s", "fx", "l_e", "l_i", "c_e", "c_i", "dlt", "ints",
              "groups.0.db.data", "groups.0.db.count", "groups.0.db.overflow",
              "groups.0.model.meta", "groups.0.model.dirs", "groups.0.model.fit.fdata",
              "groups.0.model.fit.flam", "groups.0.n_evals", "filter.theta",
              "filter.fvals", "filter.count", "filter.overflow", "traj.data",
              "traj.count", "scal.scale", "scal.offset", "scal.lb_scaled",
              "scal.ub_scaled")


def jax_leaves(st) -> dict:
    """A JAX state's leaves under ``state_to_numpy``'s names (RBF groups
    with their packed models, exact groups without)."""
    out = {f: np.asarray(getattr(st, f))
           for f in ("x", "x_s", "fx", "l_e", "l_i", "c_e", "c_i", "dlt", "ints")}
    out["traj.data"] = np.asarray(st.traj.data)
    out["traj.count"] = np.asarray(st.traj.count)
    for f in ("scale", "offset", "lb_scaled", "ub_scaled"):
        out[f"scal.{f}"] = np.asarray(getattr(st.scal, f))
    for f in ("theta", "fvals", "count", "overflow"):
        out[f"filter.{f}"] = np.asarray(getattr(st.filter, f))
    for i, g in enumerate(st.groups):
        for f in ("data", "count", "overflow"):
            out[f"groups.{i}.db.{f}"] = np.asarray(getattr(g.db, f))
        out[f"groups.{i}.n_evals"] = np.asarray(g.n_evals)
        if hasattr(g.model, "meta"):
            out[f"groups.{i}.model.meta"] = np.asarray(g.model.meta)
            out[f"groups.{i}.model.dirs"] = np.asarray(g.model.dirs)
            out[f"groups.{i}.model.fit.fdata"] = np.asarray(g.model.fit.fdata)
            out[f"groups.{i}.model.fit.flam"] = np.asarray(g.model.fit.flam)
    return out


def jax_state(template, leaves: dict):
    """``template`` (a JAX state of the same solver and lane count) with
    every leaf but the PRNG key taken from ``leaves``."""
    flat, tree = jax.tree_util.tree_flatten(template)
    assert len(flat) == len(_JAX_ORDER) + 1
    new = []
    for name, t in zip(_JAX_ORDER, flat):
        a = np.asarray(leaves[name])
        assert a.shape == t.shape, (name, a.shape, t.shape)
        new.append(jnp.asarray(a, dtype=t.dtype))
    return jax.tree_util.tree_unflatten(tree, new + flat[len(_JAX_ORDER):])


def _solver():
    s = jb.Setting(*SETTING)
    mop = jb.make_problem(s.problem, s.n_vars, s.model)
    return s, mop, build_solver(mop, jb._default_config(s), jnp.float32)


def record_port_states(pairs):
    """JAX's trip from each saved port state (``TAG=FILE`` pairs)."""
    s, mop, solver = _solver()
    x0 = halton_starts(s.n_starts, mop.lb, mop.ub)[LANE:LANE + 1]
    template = jax.jit(jax.vmap(solver.initialize))(jnp.asarray(x0, jnp.float32))
    step = jax.jit(jax.vmap(solver.iterate))
    out = {}
    for pair in pairs:
        tag, path = pair.split("=", 1)
        g = np.load(path)
        for lane in sorted({k.split("/")[0] for k in g.files}):
            get = lambda part: {k.split("/", 2)[2]: g[k] for k in g.files
                                if k.startswith(f"{lane}/{part}/")}
            before, after = get("before"), get("after")
            st = step(jax_state(template, before))
            for part, leaves in (("before", before), ("port_after", after),
                                 ("jax_after", jax_leaves(st))):
                for k, v in leaves.items():
                    out[f"{tag}_{lane}/{part}/{k}"] = v
            print(f"{tag}_{lane}: JAX stop {int(st.stop_code[0])}, iterations "
                  f"{int(st.iter_counter[0]) - 1}, evals "
                  f"{[int(g_.n_evals[0]) for g_ in st.groups]}", file=sys.stderr)
    np.savez_compressed(NAN_FITS_PATH, **out)


def main():
    if "--port-states" in sys.argv:
        return record_port_states(sys.argv[sys.argv.index("--port-states") + 1:])
    s, mop, solver = _solver()
    x0 = halton_starts(s.n_starts, mop.lb, mop.ub)[LANE:LANE + 1]
    st = jax.jit(jax.vmap(solver.initialize))(jnp.asarray(x0, jnp.float32))
    step = jax.jit(jax.vmap(solver.iterate))
    out = {}
    trip = 0
    while True:
        for k, v in jax_leaves(st).items():
            out[f"{trip}/{k}"] = v
        if int(st.stop_code[0]) != 1:
            break
        st = step(st)
        trip += 1
    np.savez_compressed(PATH, **out)
    print(f"{trip} trips, stop {int(st.stop_code[0])}, iterations "
          f"{int(st.iter_counter[0]) - 1}, evals "
          f"{[int(g.n_evals[0]) for g in st.groups]}", file=sys.stderr)


if __name__ == "__main__":
    main()
