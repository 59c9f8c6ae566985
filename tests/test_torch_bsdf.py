"""Port BSDF lobes vs terra_tpu.bsdf on numpy-seeded surfaces, directions
and uniforms: sample, pdf, eval_f, continuation_factors and delta_mask of
every lobe, one type per surface and a mix of all six.

Tolerances. Values agree to f32 rounding of the two backends' elementwise
kernels (sin, cos, pow, sqrt differ by an ulp or two): rtol 1e-5 with an
absolute floor of 1e-5 of each quantity's scale. pdf and eval_f are
evaluated at the reference's sampled directions, so they test the
formulas alone. Peaked microfacet lobes (GGX and Disney at roughness
near 0.05) are ill-conditioned: an ulp of N.h near 1 moves D by up to a
few 1e-3 relative, so at most 0.1% of lanes may exceed the tolerance, and
those stay within rtol 1e-2. A sampled direction may differ only where a lobe pick
flips: a uniform within an ulp of its threshold (Phong kd, GGX diffuse
probability, Disney mixture weights, glass Fresnel R) or a direction at
a delta lobe's alignment cut; at most 0.1% of lanes may do so.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terra_tpu import bsdf as jbsdf
from terra_tpu.ops import math3 as jmath3
from terra_tpu.scene import ATTR
from terra_tpu.surface import Surface as JSurface
from terra_tpu_torch import bsdf as tbsdf
from terra_tpu_torch.surface import Surface as TSurface

N = 4096
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """Run torch single-threaded in this module. With several threads,
    MKL's vector math on this machine has returned ~2e-4-accurate sqrt for
    the upper half of a 4096-lane tensor on the first call of a process
    that has run JAX (about one process in five; exact with one thread and
    on every later call): a fault of the test host, not of either package."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
FLIP_SHARE = 1e-3
TYPES = {"diffuse": 0, "phong": 1, "ggx": 2, "mirror": 3, "disney": 4, "glass": 5}


def _attrs(ty, gen, n):
    a = gen.random((n, 8, 3)).astype(np.float32)
    if ty == 1:
        a[:, ATTR.PHONG_SPECULAR_INTENSITY, 0] = gen.uniform(1.0, 64.0, n)
    if ty == 2:
        a[:, ATTR.GGX_ROUGHNESS, 0] = gen.uniform(0.05, 1.0, n)
    return a


def _case(kind, seed=0):
    """Both packages' surfaces, wo and uniforms for ``kind`` (a type name
    or "mixed"); wo lies in the normal's hemisphere except on glass lanes,
    which see both sides."""
    gen = np.random.default_rng(seed + 17 * len(kind))
    if kind == "mixed":
        types = gen.integers(0, 6, N).astype(np.int32)
    else:
        types = np.full(N, TYPES[kind], np.int32)
    normal = gen.normal(size=(N, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    tangent, bitangent = (np.asarray(v) for v in jmath3.build_basis(jnp.asarray(normal)))
    attrs = np.zeros((N, 8, 3), np.float32)
    for ty in np.unique(types):
        m = types == ty
        attrs[m] = _attrs(int(ty), gen, int(m.sum()))
    wo = gen.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    side = np.sign(np.sum(wo * normal, axis=1, keepdims=True))
    wo = np.where((types[:, None] == 5) | (side > 0), wo, -wo).astype(np.float32)
    fields = dict(point=np.zeros((N, 3), np.float32), normal=normal, tangent=tangent,
                  bitangent=bitangent, uv=np.zeros((N, 2), np.float32), attrs=attrs,
                  emissive=np.zeros((N, 3), np.float32), mat_id=types, bsdf_type=types,
                  ior=gen.uniform(1.2, 2.0, N).astype(np.float32),
                  t=np.ones(N, np.float32), obj_id=np.zeros(N, np.int32),
                  tri_area=np.ones(N, np.float32))
    js = JSurface(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = TSurface(**{k: torch.tensor(v) for k, v in fields.items()})
    e = [gen.random(N).astype(np.float32) for _ in range(3)]
    present = tuple(int(t) for t in np.unique(types))
    return js, ts, wo, e, present


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all() == np.isfinite(ref).all(), what
    atol = 1e-5 * max(np.abs(ref).max(), 1e-3)
    err = np.abs(got - ref)
    bad = err > atol + RTOL * np.abs(ref)
    assert bad.mean() <= FLIP_SHARE, f"{what}: {bad.sum()} lanes off, max |d| {err.max():.3e}"
    assert (err <= atol + 1e-2 * np.abs(ref)).all(), f"{what}: max |d| {err.max():.3e}"


def _t(x):
    """A torch copy of a numpy or JAX array."""
    return torch.tensor(np.array(x))


def _sampled(js, ts, wo, e, present):
    jw, jaux = jbsdf.sample(js, *(jnp.array(x) for x in e), jnp.array(wo), present)
    jw, jaux = np.array(jw), np.array(jaux)
    tw, taux = tbsdf.sample(ts, *(_t(x) for x in e), _t(wo), present)
    return (jw, jaux), (tw.numpy(), taux.numpy())


KINDS = list(TYPES) + ["mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_sample_matches_reference(kind):
    js, ts, wo, e, present = _case(kind)
    (jw, jaux), (tw, taux) = _sampled(js, ts, wo, e, present)
    off = np.abs(tw - jw).max(axis=1) > 1e-4
    assert off.mean() <= FLIP_SHARE, f"{off.sum()} of {N} sampled directions differ"
    np.testing.assert_allclose(tw[~off], jw[~off], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(taux[~off], jaux[~off])
    np.testing.assert_allclose(np.linalg.norm(tw, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_pdf_matches_reference(kind):
    js, ts, wo, e, present = _case(kind, seed=1)
    (jw, jaux), _ = _sampled(js, ts, wo, e, present)
    ref = jbsdf.pdf(js, jnp.asarray(jw), jnp.asarray(wo), jnp.asarray(jaux), present)
    got = tbsdf.pdf(ts, _t(jw), _t(wo), _t(jaux), present)
    _close(got.numpy(), ref, f"{kind} pdf")


@pytest.mark.parametrize("kind", KINDS)
def test_eval_matches_reference(kind):
    js, ts, wo, e, present = _case(kind, seed=2)
    (jw, _), _ = _sampled(js, ts, wo, e, present)
    # the sampled directions and, for the non-delta lobes, arbitrary ones
    gen = np.random.default_rng(5)
    other = gen.normal(size=(N, 3)).astype(np.float32)
    other /= np.linalg.norm(other, axis=1, keepdims=True)
    for wi in (jw, other):
        ref = jbsdf.eval_f(js, jnp.asarray(wi), jnp.asarray(wo), present)
        got = tbsdf.eval_f(ts, _t(wi), _t(wo), present)
        _close(got.numpy(), ref, f"{kind} eval_f")


@pytest.mark.parametrize("kind", KINDS)
def test_continuation_and_delta_mask_match_reference(kind):
    js, ts, wo, e, present = _case(kind, seed=3)
    (jw, _), _ = _sampled(js, ts, wo, e, present)
    jc, jsign = jbsdf.continuation_factors(js, jnp.asarray(jw), present)
    tc, tsign = tbsdf.continuation_factors(ts, _t(jw), present)
    _close(tc.numpy(), jc, f"{kind} cos factor")
    assert (jsign is None) == (tsign is None)
    if jsign is not None:
        np.testing.assert_array_equal(tsign.numpy(), np.asarray(jsign))
    jm, tm = jbsdf.delta_mask(js, present), tbsdf.delta_mask(ts, present)
    assert (jm is None) == (tm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
