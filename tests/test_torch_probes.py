"""The port's probe bodies (plain PyTorch versions, as the wrappers run
them on CPU tensors) against the reference's Pallas probes run in
interpret mode: the same (8, 128) output, word for word, on the
reference's own inputs and on seeded random ones."""
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from terra_tpu_torch import probes
from terra_tpu_torch.scripts import paged_patterns_probe, rowmask_patterns_probe, smem_dma_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]

# body -> (reference script, its function, the port's entry point)
CASES = {
    "smem_dma/hbm_to_smem": ("smem_dma_probe", "probe_hbm_to_smem",
                             smem_dma_probe.probe_hbm_to_smem),
    "smem_dma/hbm_to_smem_i32_loop": ("smem_dma_probe", "probe_hbm_to_smem_i32_loop",
                                      smem_dma_probe.probe_hbm_to_smem_i32_loop),
    "smem_dma/smem_dma_in_while": ("smem_dma_probe", "probe_smem_dma_in_while",
                                   smem_dma_probe.probe_smem_dma_in_while),
    **{f"rowmask/probe{p}": ("rowmask_patterns_probe", f"probe{p}",
                             rowmask_patterns_probe.PROBES[p]) for p in (1, 2, 3, 4)},
    **{f"paged/probe{p}": ("paged_patterns_probe", f"probe{p}",
                           paged_patterns_probe.PROBES[p]) for p in (1, 2, 3, 4)},
}


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_body_has_a_case():
    assert sorted(CASES) == sorted(probes.BODIES)
    assert len({b.kernel for b in probes.BODIES.values()}) == len(probes.KERNELS) == 6


def _reference_output(body, monkeypatch, x=None):
    """The output of the reference's probe for ``body``, its pallas_call run
    in interpret mode, on its own input or (``x``, numpy) on ``x``."""
    script, fn, _ = CASES[body]
    recorded = []
    pallas_call = pl.pallas_call

    def interpreted(*args, **kw):
        call = pallas_call(*args, **dict(kw, interpret=True))

        def run(*xs):
            out = call(*(xs if x is None else (jnp.asarray(x),)))
            recorded.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    with jax.default_device(jax.devices("cpu")[0]):
        getattr(_reference_script(script), fn)()
    assert len(recorded) == 1
    return recorded[0]


@pytest.mark.parametrize("body", list(CASES))
def test_probe_matches_pallas_interpret(body, monkeypatch):
    ref = _reference_output(body, monkeypatch)
    out, ok = CASES[body][2](device="cpu")
    got = out.numpy()
    assert ok
    assert got.dtype == ref.dtype and got.shape == ref.shape == (8, 128)
    assert int((got.view(np.int32) != ref.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_refuses_wrong_input(bad):
    import torch

    x = torch.zeros((64, 128), dtype=torch.int32 if bad == "dtype" else torch.float32)
    if bad == "shape":
        x = x[:8]
    with pytest.raises(ValueError):
        probes.run("smem_dma/hbm_to_smem", x)


@pytest.mark.parametrize("seed", range(probes.SEEDS))
@pytest.mark.parametrize("body", list(CASES))
def test_seeded_probe_matches_pallas_interpret(body, seed, monkeypatch):
    """The seeded inputs chip_smoke.py's phase 5 holds the probe kernels to,
    through the plain version and the reference's probe."""
    x = probes.seeded_input(body, seed, device="cpu")
    assert bool((x.abs() < 2**24).all())
    ref = _reference_output(body, monkeypatch, x.numpy())
    got = probes.run(body, x).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (8, 128)
    assert int((got.view(np.int32) != ref.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("n", [n for n in probes.LOOP_EDGES if n <= probes.W])
def test_loop_edges_match_pallas_interpret(n, monkeypatch):
    """The loop probe at the trip counts where the kernel's split of the
    loop over a warp's lanes has its edges (none, one, 31-33 and 127-128
    words), through the plain version and the reference's probe."""
    x = probes.edge_inputs(probes.LOOP, device="cpu")[n]
    assert int(x[0, 0]) == n
    ref = _reference_output(probes.LOOP, monkeypatch, x.numpy())
    got = probes.run(probes.LOOP, x).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (8, 128)
    assert int((got.view(np.int32) != ref.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("n", [n for n in probes.LOOP_EDGES if n > probes.W])
def test_loop_stops_at_128_trips(n):
    """Past 128 trips the reference reads beyond its (4, 128) scratch (out
    of bounds on the TPU; the interpreter clamps the column), so it is not
    the yardstick there: the port's loop stops at the row's 128 words."""
    x = probes.edge_inputs(probes.LOOP, device="cpu")[n]
    xs = x.numpy().astype(np.int64)
    want = sum(int(xs[i % 4, i]) for i in range(probes.W))
    assert want < 2**31
    got = probes.run(probes.LOOP, x).numpy()
    assert got.dtype == np.int32 and (got == want).all()


def test_seeded_inputs_reach_both_branches():
    """Paged probe 4's page links fall on both sides of the push test and
    rowmask probe 3's rows on both sides of 700 in every seeded input."""
    for seed in range(probes.SEEDS):
        links = probes.seeded_input("paged/probe4", seed, "cpu")[[2, 6, 10]].amin(dim=1)
        assert bool((links <= 4).any()) and bool((links > 4).any())
        rows = (probes.seeded_input("rowmask/probe3", seed, "cpu")[:8] > 700).any(dim=1)
        assert 0 < int(rows.sum()) < 8


def test_seeded_mask_planes_reach_both_gates():
    """Rowmask probe 4's seeded rows cross each mask plane's threshold
    (600, 700, 800) in some rows and not in others, so every input takes
    both sides of every plane's row gate."""
    for seed in range(probes.SEEDS):
        x = probes.seeded_input("rowmask/probe4", seed, "cpu")[:8]
        for s in range(3):
            rows = (x > 600.0 + 100.0 * s).any(dim=1)
            assert 0 < int(rows.sum()) < 8, (seed, s)


def test_redesign_rank():
    """launches x (ms - bound), largest first; a kernel at half its bound
    (nothing to save) is left out."""
    rows = {"paged": {"launches": 4, "ms": 0.004, "bound_ms": 3.1e-6},
            "rowmask": {"launches": 3, "ms": 0.005, "bound_ms": 2.4e-6},
            "once": {"launches": 1, "ms": 0.006, "bound_ms": 1.5e-6},
            "at_half_bound": {"launches": 9, "ms": 1e-6, "bound_ms": 2e-6}}
    rank = probes.redesign_rank(rows)
    assert [k for k, _ in rank] == ["paged", "rowmask", "once"]
    assert rank[0][1] == pytest.approx(4 * (0.004 - 3.1e-6))
    assert probes.redesign_rank({"x": {"launches": 0, "ms": 1.0, "bound_ms": 0.0}}) == []


def test_floor_and_kernels_refuse_cpu_tensors():
    """The floor and the kernels launch only on CUDA tensors; the wrapper
    takes the plain version on the CPU instead."""
    x = probes.make_input("paged/probe1", "cpu")
    for threads in (256, 32):
        with pytest.raises(ValueError, match="cuda tensors"):
            probes.run_floor(x, threads)
    with pytest.raises(ValueError, match="block size"):
        probes.run_floor(x, 64)
    with pytest.raises(ValueError):
        probes.launch("paged/probe1", x)
    assert torch.equal(probes.run("paged/probe1", x), probes.run_plain("paged/probe1", x))


def test_parse_sass_ignores_column_padding():
    """cuobjdump pads every kernel's columns to the widest instruction of
    the library, so a kernel left alone must read the same beside a
    neighbour with longer instructions, and a changed one must not."""
    def dump(pad, mov="MOV R0, 0x400"):
        return (f"\tcode for sm_90a\n\t\tFunction : k_kernel\n\t.headerflags @\"EF_CUDA_SM90\"\n"
                f"        /*0000*/{' ' * pad}{mov} ;{' ' * pad}/* 0x0000040000008802 */\n"
                f"\t\tFunction : other_kernel\n        /*0000*/ EXIT ;\n")
    a, b = probes.parse_sass(dump(19)), probes.parse_sass(dump(23))
    assert sorted(a) == ["k_kernel", "other_kernel"]
    assert a == b
    assert probes.parse_sass(dump(19, "MOV R1, 0x400"))["k_kernel"] != a["k_kernel"]


def test_block_sizes_match_the_launchers():
    """:data:`probes.KERNELS` gives each kernel the block its C launcher
    launches, so the launch floor is timed at each kernel's own shape."""
    src = pathlib.Path(probes.SRC).read_text()
    launched = {fn: {"BLOCK": 256}.get(threads, threads) for fn, threads in re.findall(
        r'extern "C" int (\w+)\([^)]*\) \{\s*\w+_kernel<<<1, (\w+),', src)}
    assert {fn: int(t) for fn, t in launched.items() if fn != probes.FLOOR} == {
        fn: threads for fn, _, threads in probes.KERNELS.values()}
    assert launched[probes.FLOOR] == "block"
