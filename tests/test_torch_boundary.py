"""The port's boundary module against the reference's, float64, bit for
bit: the enums' values, every ``apply_*`` function (copies and fills, so
``assert_array_equal``), the inlet profiles and time profiles, the
outlets, symmetry, ``copy_boundary_velocities``, the corners of a
6×5×4 field, the handlers, and ``NSParams.from_fields`` carrying a
``ThermalBCConfig`` across.  Both packages get the same numpy inputs."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.boundary as jb
import cfd_tpu_torch.boundary as tb
from cfd_tpu.boundary import types as jtypes
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.boundary import handlers, types as ttypes
from cfd_tpu_torch.solvers.ns.params import NSParams

SHAPE3 = (4, 5, 6)     # (nz, ny, nx): a 6×5×4 field
SHAPE2 = (1, 5, 6)


def _arrays(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(n)]


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


def _equal(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_public_names_match_reference():
    assert sorted(tb.__all__) == sorted(jb.__all__)
    for name in tb.__all__:
        assert hasattr(tb, name), name


@pytest.mark.parametrize("enum_name", [
    "BCType", "Edge", "InletProfile", "InletSpecType", "OutletType",
    "TimeProfile"])
def test_enum_values_match_reference(enum_name):
    ours, theirs = getattr(ttypes, enum_name), getattr(jtypes, enum_name)
    assert {m.name: int(m) for m in ours} == {m.name: int(m)
                                              for m in theirs}


def test_handler_enums_and_backends():
    from cfd_tpu.boundary import handlers as jh
    for ours, theirs in ((handlers.BCErrorCode, jh.BCErrorCode),
                         (handlers.BCBackend, jh.BCBackend)):
        assert {m.name: int(m) for m in ours} == {m.name: int(m)
                                                  for m in theirs}
    calls = []
    handlers.set_error_handler(lambda *a: calls.append(a), "data")
    try:
        handlers.report_error(handlers.BCErrorCode.INVALID, "f", "msg")
        assert calls == [(handlers.BCErrorCode.INVALID, "f", "msg", "data")]
        assert handlers.get_error_handler() is not None
    finally:
        handlers.set_error_handler(None)
    assert handlers.get_error_handler() is None
    for b in (handlers.BCBackend.AUTO, handlers.BCBackend.SCALAR,
              handlers.BCBackend.OMP, handlers.BCBackend.SIMD):
        assert handlers.set_backend(b) and handlers.get_backend() == b
    assert handlers.set_backend(handlers.BCBackend.CUDA) == \
        torch.cuda.is_available()
    handlers.set_backend(handlers.BCBackend.AUTO)
    assert handlers.get_backend_name() == "auto"


@pytest.mark.parametrize("shape", [SHAPE3, SHAPE2], ids=["3d", "2d"])
@pytest.mark.parametrize("kind", ["periodic", "neumann", "dirichlet"])
def test_apply_scalar_matches_reference(kind, shape):
    (ja,), (ta,) = _both(_arrays(shape, 1))
    values = dict(left=1.0, right=2.0, top=3.0, bottom=4.0, front=5.0,
                  back=6.0)
    bc = getattr(jb.BCType, kind.upper())
    _equal(tb.apply_scalar(ta, int(bc), tb.DirichletValues(**values)),
           jb.apply_scalar(ja, bc, jb.DirichletValues(**values)))
    # the (ny, nx) form: one plane
    _equal(tb.apply_scalar(ta[0], int(bc), tb.DirichletValues(**values)),
           jb.apply_scalar(ja[0], bc, jb.DirichletValues(**values)))
    assert torch.equal(ta, torch.tensor(_arrays(shape, 1)[0]))  # untouched


def test_apply_scalar_rejects_noslip():
    with pytest.raises(CFDError) as err:
        tb.apply_scalar(torch.zeros(SHAPE3), tb.BCType.NOSLIP)
    assert err.value.status == Status.ERROR_INVALID


@pytest.mark.parametrize("shape", [SHAPE3, SHAPE2], ids=["3d", "2d"])
def test_velocity_bcs_match_reference(shape):
    (ju, jv, jw), (tu, tv, tw) = _both(_arrays(shape, 3, 1))
    _equal(tb.apply_noslip(tu, tv, tw), jb.apply_noslip(ju, jv, jw))
    _equal(tb.apply_noslip(tu, tv), jb.apply_noslip(ju, jv))
    uvals = dict(left=1.0, right=-1.0, top=2.0)
    vvals = dict(bottom=0.5, back=3.0)
    _equal(tb.apply_dirichlet_velocity(
        tu, tv, tb.DirichletValues(**uvals), tb.DirichletValues(**vvals), tw,
        tb.DirichletValues(front=7.0)),
        jb.apply_dirichlet_velocity(
            ju, jv, jb.DirichletValues(**uvals), jb.DirichletValues(**vvals),
            jw, jb.DirichletValues(front=7.0)))
    for bc in ("PERIODIC", "NEUMANN", "NOSLIP"):
        _equal(tb.apply_velocity(tu, tv, tb.BCType[bc], tw),
               jb.apply_velocity(ju, jv, jb.BCType[bc], jw))


def _profile(pos):
    return 1.0 + pos * pos, -pos


def _profile_time(pos, t, dt):
    return pos * (1.0 + t), 0.5 * pos


INLETS = {
    "uniform": lambda m: m.InletConfig.uniform(1.5, -0.5),
    "parabolic_left": lambda m: m.InletConfig.parabolic(2.0),
    "parabolic_top": lambda m: m.InletConfig.parabolic(2.0, m.Edge.TOP),
    "parabolic_bottom": lambda m: m.InletConfig.parabolic(1.0,
                                                          m.Edge.BOTTOM),
    "magnitude_dir": lambda m: m.InletConfig.magnitude_dir(
        2.0, 0.3, m.Edge.RIGHT),
    "mass_flow_top": lambda m: m.InletConfig.mass_flow(3.0, 1.5, 2.0,
                                                       m.Edge.TOP),
    "mass_flow_back": lambda m: m.InletConfig.mass_flow(3.0, 1.5, 2.0,
                                                        m.Edge.BACK),
    "custom": lambda m: m.InletConfig.custom(_profile, m.Edge.BOTTOM),
    "front_uniform": lambda m: m.InletConfig.uniform(0.25, 0.5,
                                                     m.Edge.FRONT),
    "sinusoidal": lambda m: m.InletConfig.time_sinusoidal(
        1.0, 0.2, 2.0, 0.5, 0.1, 1.0),
    "ramp": lambda m: m.InletConfig.time_ramp(1.0, 0.0, 0.1, 0.5, 0.0, 2.0),
    "ramp_invalid": lambda m: m.InletConfig.time_ramp(1.0, 0.0, 0.5, 0.1,
                                                      0.0, 2.0),
    "step": lambda m: m.InletConfig.time_step(1.0, 0.5, 0.3, 0.5, 1.5),
    "time_custom": lambda m: m.InletConfig.time_custom(_profile_time,
                                                       m.Edge.TOP),
    "parabolic_sinusoidal": lambda m: m.InletConfig.parabolic(
        1.0).with_time_sinusoidal(1.0, 0.5, 0.0, 1.0).with_edge(
        m.Edge.RIGHT),
}


@pytest.mark.parametrize("time", [None, 0.0, 0.2, 0.7])
@pytest.mark.parametrize("name", sorted(INLETS))
def test_apply_inlet_matches_reference(name, time):
    """Every profile and time profile on a 3D field (w zeroed on an x/y
    edge), at a few times.  The sinusoid is a libm sine of a float64
    argument in both packages: held at 1 ulp of its value."""
    (ju, jv, jw), (tu, tv, tw) = _both(_arrays(SHAPE3, 3, 2))
    got = tb.apply_inlet(tu, tv, INLETS[name](tb), tw, time=time, dt=1e-3)
    ref = jb.apply_inlet(ju, jv, INLETS[name](jb), jw, time=time, dt=1e-3)
    if "sinusoidal" in name and time is not None:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=4e-16)
    else:
        _equal(got, ref)


def test_apply_inlet_2d_and_errors():
    (ju, jv), (tu, tv) = _both(_arrays(SHAPE2, 2, 3))
    for name in ("uniform", "parabolic_left", "custom", "step"):
        _equal(tb.apply_inlet(tu, tv, INLETS[name](tb), time=0.4),
               jb.apply_inlet(ju, jv, INLETS[name](jb), time=0.4))
    with pytest.raises(CFDError):   # a z-face inlet needs 3D and w
        tb.apply_inlet(tu, tv, INLETS["front_uniform"](tb))
    with pytest.raises(CFDError):
        tb.apply_inlet(tu, tv, tb.InletConfig(edge=tb.Edge.ALL_2D))


def test_time_modulator_on_device_tensors():
    """A modulator takes a 0-d tensor and returns one on its device, so a
    step never reads t on the host."""
    t = torch.tensor(0.3, dtype=torch.float32)
    for name in ("sinusoidal", "ramp", "step"):
        m = INLETS[name](tb).time_config.modulator(t, 1e-3)
        assert torch.is_tensor(m) and m.dtype == torch.float32
        jm = INLETS[name](jb).time_config.modulator(0.3, 1e-3)
        np.testing.assert_allclose(float(m), float(jm), rtol=1e-6)
    assert tb.TimeConfig().modulator(t, 1e-3) == 1.0


@pytest.mark.parametrize("shape", [SHAPE3, SHAPE2], ids=["3d", "2d"])
@pytest.mark.parametrize("edge", ["LEFT", "RIGHT", "BOTTOM", "TOP", "BACK",
                                  "FRONT"])
@pytest.mark.parametrize("convective", [False, True])
def test_outlets_match_reference(edge, convective, shape):
    (ju, jv, jw), (tu, tv, tw) = _both(_arrays(shape, 3, 4))
    if shape[0] == 1 and edge in ("BACK", "FRONT"):
        with pytest.raises(CFDError):
            tb.apply_outlet_scalar(tu, tb.OutletConfig(edge=tb.Edge[edge]))
        return

    def cfg(m):
        if convective:
            return m.OutletConfig.convective(0.7, m.Edge[edge],
                                             true_convective=True)
        return m.OutletConfig.zero_gradient(m.Edge[edge])

    _equal(tb.apply_outlet_scalar(tu, cfg(tb), 1e-2, 0.1),
           jb.apply_outlet_scalar(ju, cfg(jb), 1e-2, 0.1))
    _equal(tb.apply_outlet_velocity(tu, tv, cfg(tb), tw, 1e-2, 0.1),
           jb.apply_outlet_velocity(ju, jv, cfg(jb), jw, 1e-2, 0.1))


@pytest.mark.parametrize("shape", [SHAPE3, SHAPE2], ids=["3d", "2d"])
@pytest.mark.parametrize("edges", ["LEFT", "RIGHT", "BOTTOM", "TOP",
                                   "BACK", "FRONT", "ALL_3D"])
def test_symmetry_matches_reference(edges, shape):
    (ju, jv, jw), (tu, tv, tw) = _both(_arrays(shape, 3, 5))
    _equal(tb.apply_symmetry(tu, tv, tb.SymmetryConfig(tb.Edge[edges]), tw),
           jb.apply_symmetry(ju, jv, jb.SymmetryConfig(jb.Edge[edges]), jw))
    _equal(tb.apply_symmetry(tu, tv, tb.SymmetryConfig(tb.Edge[edges])),
           jb.apply_symmetry(ju, jv, jb.SymmetryConfig(jb.Edge[edges])))


@pytest.mark.parametrize("shape", [SHAPE3, SHAPE2], ids=["3d", "2d"])
def test_copy_boundary_velocities_matches_reference(shape):
    arrays = _arrays(shape, 6, 6)
    ja, ta = _both(arrays)
    _equal(tb.copy_boundary_velocities(*ta),
           jb.copy_boundary_velocities(*ja))


def test_corners_last_writer_wins_3d():
    """Mixed faces on a 6×5×4 field: every corner and edge point is owned
    by the face the reference writes last (z, then y, then x)."""
    (ja,), (ta,) = _both(_arrays(SHAPE3, 1, 7))
    vals = dict(left=1.0, right=2.0, top=3.0, bottom=4.0, front=5.0,
                back=6.0)
    got = tb.apply_dirichlet_scalar(ta, tb.DirichletValues(**vals))
    _equal(got, jb.apply_dirichlet_scalar(ja, jb.DirichletValues(**vals)))
    assert float(got[0, 0, 0]) == 6.0 and float(got[-1, -1, -1]) == 5.0
    assert float(got[1, 0, 0]) == 4.0 and float(got[1, -1, -1]) == 3.0
    g = ta
    h = ja
    for fn_t, fn_j in ((tb.apply_periodic_scalar, jb.apply_periodic_scalar),
                       (tb.apply_neumann_scalar, jb.apply_neumann_scalar)):
        g, h = fn_t(g), fn_j(h)
        _equal(g, h)


def test_thermal_specs_match_reference():
    B = jb.BCType
    for faces in ((B.DIRICHLET, B.NEUMANN), (B.NEUMANN, B.PERIODIC),
                  (B.PERIODIC, B.DIRICHLET)):
        kw = dict(back=faces[0], front=faces[1], bottom=faces[1],
                  top=faces[0])
        vals = dict(back=1.5, front=2.5, bottom=3.5, top=4.5)
        jc = jb.ThermalBCConfig(**kw, dirichlet_values=jb.DirichletValues(
            **vals))
        tc = tb.ThermalBCConfig(**{k: tb.BCType(int(v))
                                   for k, v in kw.items()},
                                dirichlet_values=tb.DirichletValues(**vals))
        for fn in ("thermal_z_specs", "thermal_y_specs"):
            assert getattr(ttypes, fn)(tc) == getattr(jtypes, fn)(jc)
            assert getattr(ttypes, fn)(tc, ("pN2", "p1"), ("p1", "pN2")) == \
                getattr(jtypes, fn)(jc, ("pN2", "p1"), ("p1", "pN2"))
        assert tc.face_types() == tuple(tb.BCType(int(f))
                                        for f in jc.face_types())


def test_config_constructors_match_reference():
    for name, make in INLETS.items():
        ours, theirs = dataclasses.asdict(make(tb)), dataclasses.asdict(
            make(jb))
        assert ours.keys() == theirs.keys(), name
        for k in ours:
            if k not in ("custom_profile", "custom_profile_time",
                         "time_config"):
                assert ours[k] == theirs[k], (name, k)
        assert dataclasses.asdict(make(tb).time_config).keys() == \
            dataclasses.asdict(make(jb).time_config).keys()
    assert dataclasses.asdict(tb.OutletConfig.convective(
        0.5, tb.Edge.TOP)) == dataclasses.asdict(jb.OutletConfig.convective(
            0.5, jb.Edge.TOP))
    assert int(tb.SymmetryConfig().edges) == int(jb.SymmetryConfig().edges)
    assert ttypes.edge_is_single(tb.Edge.FRONT)
    assert not ttypes.edge_is_single(tb.Edge.ALL_2D)
    assert math.isclose(tb.InletConfig.magnitude_dir(2.0, 0.3).magnitude,
                        2.0)


def test_from_fields_carries_thermal_bc_across():
    """A reference ThermalBCConfig becomes the port's, face by face and
    value by value; the port's default is the reference's all-periodic
    config, not None."""
    B = jb.BCType
    jc = jb.ThermalBCConfig(left=B.DIRICHLET, right=B.NEUMANN,
                            bottom=B.SYMMETRY, back=B.DIRICHLET,
                            dirichlet_values=jb.DirichletValues(
                                left=310.0, back=-1.0))
    tp = NSParams.from_fields(JParams(alpha=1e-3, thermal_bc=jc))
    assert isinstance(tp.thermal_bc, tb.ThermalBCConfig)
    for f in ("left", "right", "bottom", "top", "front", "back"):
        assert int(getattr(tp.thermal_bc, f)) == int(getattr(jc, f)), f
        assert isinstance(getattr(tp.thermal_bc, f), tb.BCType)
        assert getattr(tp.thermal_bc.dirichlet_values, f) == \
            getattr(jc.dirichlet_values, f), f
    assert NSParams().thermal_bc == tb.ThermalBCConfig()
    assert [int(f) for f in NSParams().thermal_bc.face_types()] == \
        [int(f) for f in JParams().thermal_bc.face_types()]
