"""The port's probe bodies (plain PyTorch versions, as the wrappers run
them on CPU tensors) against the reference's Pallas probes run in
interpret mode: the same (8, 128) output, word for word."""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
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


@pytest.mark.parametrize("body", list(CASES))
def test_probe_matches_pallas_interpret(body, monkeypatch):
    script, fn, port_fn = CASES[body]
    recorded = []
    pallas_call = pl.pallas_call

    def interpreted(*args, **kw):
        call = pallas_call(*args, **dict(kw, interpret=True))

        def run(*xs):
            out = call(*xs)
            recorded.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    with jax.default_device(jax.devices("cpu")[0]):
        getattr(_reference_script(script), fn)()
    assert len(recorded) == 1
    ref = recorded[0]
    out, ok = port_fn(device="cpu")
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
