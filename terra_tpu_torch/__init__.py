"""terra_tpu_torch: the terra_tpu path tracer in PyTorch, with CUDA kernels
for NVIDIA Hopper.

A port of ``terra_tpu`` (JAX on a TPU) that keeps its module paths and
names. It imports neither JAX nor ``terra_tpu``; the JAX package is the
reference its tests compare against. The scene builders, cameras and
``interop``'s loaders put their tensors on ``"cuda"`` unless the caller
passes ``device="cpu"``; CPU tensors take the plain PyTorch versions of
the kernels, CUDA tensors the kernels themselves. On the card ``render``
captures each launch unit (``render_chunk`` and its kin) as a CUDA graph
once and replays it (``graphs.py``); ``render.render_rows`` is the eager
body by name.

    import terra_tpu_torch as ttt
    scene = ttt.scenes.courtyard(device="cuda")
    cam = ttt.scenes.courtyard_camera(device="cuda")
    film = ttt.render(scene, cam, ttt.RenderOptions(width=384, height=384,
                      samples_per_pixel=8, bounces=2,
                      integrator=ttt.Integrator.DIRECT))
    image = ttt.develop(film)

Importing the package sets ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8``
unless the process has its own: cuBLAS repeats a product's bits only with
a fixed workspace configuration, read when the process makes its first
cuBLAS call, and the training backward's small-table products
(``ops/onehot.py``) run in PyTorch's deterministic mode
(``optim.deterministic``).
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from .scene import (  # noqa: F401
    ATTR, Accelerator, BSDFType, Camera, Geometry, Integrator, Intersector, LightPick,
    LightTable, MaterialTable, RenderOptions, SamplingMethod, Scene, TextureAtlas, Tonemap,
    commit,
)
from .film import Film, develop, tonemap  # noqa: F401
from .render import render, render_chunk, trace  # noqa: F401
from . import scenes  # noqa: F401

__version__ = "0.1.0"
