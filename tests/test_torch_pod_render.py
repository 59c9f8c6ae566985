"""The port's sharded scripts on local gloo ranks on the CPU (``--cpu-mesh
N``): ``pod_render`` (bench config 5) killed after its first checkpoint and
resumed in another layout, ``inverse_render --sharded`` against the
unsharded run, and ``scaling_bench``'s JSON line."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = ["--width", "16", "--height", "16", "--spp", "16", "--chunk", "2", "--bounces", "2",
       "--integrator", "direct", "--checkpoint-every", "1"]


def _cmd(module, *args):
    return [sys.executable, "-m", f"terra_tpu_torch.scripts.{module}", *args]


def _run(cmd, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _film(path):
    with np.load(path) as z:
        return z["acc"], z["samples"]


def test_pod_render_killed_and_resumed_in_another_layout(tmp_path):
    """4 row ranks, SIGKILL once the first checkpoint exists; then 2 sample
    ranks resume that file to 16 spp and write the image. The film equals
    an uninterrupted run's (one process adding the same 2-sample chunks in
    order) within f32 reassociation of the sample sums."""
    import torch

    import terra_tpu_torch as ttt
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import render_rows

    opts = ttt.RenderOptions(width=16, height=16, samples_per_pixel=16, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    scene, cam = ttt.scenes.cornell_box(device="cpu"), ttt.scenes.cornell_camera(device="cpu")
    whole = torch.zeros((16, 16, 3))
    for done in range(0, 16, 2):
        whole += render_rows(scene, cam, opts, rng.key_from_seed(0), done, 2, 0, 16)
    whole = whole.numpy()

    ckpt = tmp_path / "killed.npz"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(_cmd("pod_render", "--cpu-mesh", "4", *POD, "--checkpoint", str(ckpt),
                                 "-o", "killed.png"), cwd=tmp_path, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 240
        while not ckpt.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ckpt.exists(), "no checkpoint before the run ended"
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    _, n_killed = _film(ckpt)
    assert (n_killed == n_killed[0, 0]).all() and 0 < n_killed[0, 0] < 16
    assert not (tmp_path / "killed.png").exists()

    out = _run(_cmd("pod_render", "--cpu-mesh", "2", "--sample-ways", "2", *POD,
                    "--checkpoint", str(ckpt), "-o", "resumed.png"), tmp_path)
    assert f"resumed at {n_killed[0, 0]} spp" in out and "mesh: {'rows': 1, 'samples': 2}" in out
    acc, n = _film(ckpt)
    assert (n == 16).all() and (tmp_path / "resumed.png").exists()
    np.testing.assert_allclose(acc, whole, rtol=1e-5, atol=1e-6 * float(np.abs(whole).max()))


def test_inverse_render_sharded_matches_unsharded(tmp_path):
    """inverse_render --sharded on 2 CPU ranks: the losses of every step
    equal the single-process run's within rtol 1e-5."""
    from terra_tpu_torch.scripts import inverse_render

    args = ["--steps", "2", "--size", "16", "--device", "cpu"]
    out = _run(_cmd("inverse_render", "--sharded", "--cpu-mesh", "2", *args), tmp_path)
    line = [ln for ln in out.splitlines() if ln.startswith("losses ")]
    assert len(line) == 1, out
    sharded = json.loads(line[0][len("losses "):])
    ref = inverse_render.main(args)["losses"]
    assert len(sharded) == 2
    np.testing.assert_allclose(sharded, ref, rtol=1e-5)


def test_scaling_bench_json_line(tmp_path):
    out = _run(_cmd("scaling_bench", "--cpu-mesh", "2", "--device", "cpu", "--width", "8",
                    "--height", "8", "--spp", "2", "--bounces", "1", "--iters", "1"), tmp_path)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["metric"] == "scaling_efficiency" and rec["devices"] == 2
    assert sorted(rec["total_mrays_by_mesh_size"]) == ["1", "2"]
    assert rec["efficiency_at_max"] > 0


@pytest.mark.parametrize("module", ["pod_render", "inverse_render", "scaling_bench"])
def test_scripts_run_on_cuda_unless_asked_for_the_cpu(module):
    """Without --device cpu (or --cpu-mesh) a sharded script asks for the
    card before it joins a process group; a machine without one raises
    naming the CPU option, and nothing falls back."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    main = importlib.import_module(f"terra_tpu_torch.scripts.{module}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--sharded"] if module == "inverse_render" else [])
