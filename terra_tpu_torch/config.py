"""Typed option registry + config-file parsing (port of
``terra_tpu/config.py``).

The satellite Config system (Config.cpp + Config.hpp): named options with
description/type/default (Config.hpp:19-113), a ``key = value`` file
format with ``#`` comments searched in ./, ../, data/ (Config.cpp:115-165),
and string<->enum mappers onto this package's renderer types. The option
names, defaults and file format are the JAX package's, so a
``satellite.config`` written by either package loads in the other.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .scene import Accelerator, Camera, Integrator, Intersector, LightPick, RenderOptions, SamplingMethod, Tonemap

__all__ = ["OPTIONS", "SCENE_OPTIONS", "Config", "load_config_file", "find_config_file"]

# Options whose change requires a scene re-commit — the reference's
# effect classification (App.cpp:663-672 -> Scene.cpp:426-454 diffs every
# option write and rebuilds only the affected subsystem). Everything else
# only affects the next render launch (RenderOptions/Camera are rebuilt
# from the config each step) or the film (cleared by the caller).
SCENE_OPTIONS = frozenset({
    "scene", "envmap_color", "render_accelerator", "render_bvh_builder",
})

CONFIG_SEARCH_PATHS = ["./", "../", "data/"]  # Config.cpp:115-124
DEFAULT_CONFIG_NAME = "satellite.config"


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


def _parse_float3(s: str) -> Tuple[float, float, float]:
    parts = s.replace("(", " ").replace(")", " ").replace(",", " ").split()
    vals = [float(p) for p in parts]
    if len(vals) == 1:
        vals = vals * 3
    return tuple(vals[:3])


_TONEMAP = {
    "none": Tonemap.NONE, "linear": Tonemap.LINEAR, "reinhard": Tonemap.REINHARD,
    "filmic": Tonemap.FILMIC, "uncharted2": Tonemap.UNCHARTED2,
}
_SAMPLER = {
    "random": SamplingMethod.RANDOM, "stratified": SamplingMethod.STRATIFIED,
    "halton": SamplingMethod.HALTON,
}
_ACCEL = {"bvh": Accelerator.BVH, "brute": Accelerator.BRUTE}
_INTERSECTOR = {"mt": Intersector.MT, "watertight": Intersector.WATERTIGHT}
_LIGHT_PICK = {"uniform": LightPick.UNIFORM, "area": LightPick.AREA}
_INTEGRATOR = {
    "simple": Integrator.SIMPLE, "direct": Integrator.DIRECT,
    "direct-mis": Integrator.DIRECT_MIS, "direct_mis": Integrator.DIRECT_MIS,
    "debug-mono": Integrator.DEBUG_MONO, "debug-depth": Integrator.DEBUG_DEPTH,
    "debug-normals": Integrator.DEBUG_NORMALS,
    "debug-mis-weights": Integrator.DEBUG_MIS_WEIGHTS,
}


@dataclass(frozen=True)
class OptionSpec:
    name: str
    desc: str
    parse: Callable[[str], Any]
    default: Any


# The reference option list (Config.hpp:19-113); names preserved.
OPTIONS: Dict[str, OptionSpec] = {
    o.name: o
    for o in [
        OptionSpec("width", "Output image width", int, 256),
        OptionSpec("height", "Output image height", int, 256),
        OptionSpec("render_bounces", "Maximum path bounces", int, 4),
        OptionSpec("render_samples", "Samples per pixel", int, 64),
        OptionSpec("render_gamma", "Display gamma", float, 2.2),
        OptionSpec("render_exposure", "Manual exposure multiplier", float, 1.0),
        OptionSpec("render_tonemap", "none|linear|reinhard|filmic|uncharted2", lambda s: _TONEMAP[s.lower()], Tonemap.NONE),
        OptionSpec("render_sampler", "random|stratified|halton", lambda s: _SAMPLER[s.lower()], SamplingMethod.RANDOM),
        OptionSpec("render_accelerator", "bvh|brute", lambda s: _ACCEL[s.lower()], Accelerator.BVH),
        OptionSpec("render_bvh_builder", "sah|lbvh BVH build algorithm", lambda s: s.lower(), "sah"),
        OptionSpec("render_intersector", "mt|watertight", lambda s: _INTERSECTOR[s.lower()], Intersector.MT),
        OptionSpec("render_integrator", "simple|direct|direct-mis|debug-*", lambda s: _INTEGRATOR[s.lower()], Integrator.DIRECT_MIS),
        OptionSpec("render_jitter", "Subpixel jitter amplitude", float, 0.0),
        OptionSpec("render_strata", "Strata per dimension (stratified)", int, 4),
        OptionSpec("render_samples_per_launch", "spp per device launch (0=all)", int, 0),
        # Default 8 here vs 1 in RenderOptions: CLI/config users get the fast
        # persistent-lane scheduler; API users get deterministic accumulation
        # order (see scene.py RenderOptions.samples_per_lane).
        OptionSpec("render_samples_per_lane", "samples traced back-to-back per lane", int, 8),
        OptionSpec("render_light_pick", "uniform|area NEE light pick", lambda s: _LIGHT_PICK[s.lower()], LightPick.UNIFORM),
        OptionSpec("render_debug_checks", "host-validate each chunk (NaN guard)", _parse_bool, False),
        OptionSpec("camera_position", "Camera position x,y,z", _parse_float3, (0.0, 0.9, 2.4)),
        OptionSpec("camera_direction", "Camera direction x,y,z", _parse_float3, (0.0, 0.0, -1.0)),
        OptionSpec("camera_up", "Camera up vector", _parse_float3, (0.0, 1.0, 0.0)),
        OptionSpec("camera_fov", "Vertical field of view (degrees)", float, 45.0),
        OptionSpec("envmap_color", "Constant environment color", _parse_float3, (0.0, 0.0, 0.0)),
        OptionSpec("render_env_on_miss", "Add env radiance on miss (reference disables it, Terra.c:1056)", _parse_bool, False),
        OptionSpec("render_env_nee", "Importance-sample the env as a light (extension)", _parse_bool, False),
        OptionSpec("scene", "Scene OBJ path", str, ""),
        OptionSpec("seed", "RNG seed", int, 0),
        # kept for config-file compatibility; nothing schedules tiles or threads
        OptionSpec("workers", "(compat) worker threads — unused", int, 0),
        OptionSpec("tile_size", "(compat) tile size — unused", int, 128),
        OptionSpec("progressive", "(compat) progressive updates", int, 1),
    ]
}


class Config:
    """A mutable option store with validation (satellite Config.cpp)."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self.values: Dict[str, Any] = {k: v.default for k, v in OPTIONS.items()}
        # options written explicitly (file or set()) vs registry defaults —
        # lets callers distinguish "user asked for X" from "default is X"
        self.explicit: set = set()
        if values:
            self.values.update(values)
            self.explicit.update(values)

    def set(self, name: str, raw: str):
        if name not in OPTIONS:
            raise KeyError(f"unknown option: {name}")
        spec = OPTIONS[name]
        self.values[name] = spec.parse(raw) if isinstance(raw, str) else raw
        self.explicit.add(name)

    def scene_state(self) -> tuple:
        """Hashable snapshot of every scene-affecting option — compare
        before/after an option write to decide whether the scene must be
        re-committed (Scene.cpp:426-454's diff)."""
        return tuple(self.values[k] for k in sorted(SCENE_OPTIONS))

    def get(self, name: str):
        return self.values[name]

    def describe(self) -> List[str]:
        return [f"{k:28s} {OPTIONS[k].desc} (= {self.values[k]!r})" for k in sorted(OPTIONS)]

    # ------------------------------------------------------------ exports
    def render_options(self, **overrides) -> RenderOptions:
        v = self.values
        opts = RenderOptions(
            width=v["width"], height=v["height"],
            samples_per_pixel=v["render_samples"], bounces=v["render_bounces"],
            integrator=v["render_integrator"], sampling_method=v["render_sampler"],
            accelerator=v["render_accelerator"], tonemap=v["render_tonemap"],
            intersector=v["render_intersector"],
            subpixel_jitter=v["render_jitter"], strata=v["render_strata"],
            manual_exposure=v["render_exposure"], gamma=v["render_gamma"],
            samples_per_launch=v["render_samples_per_launch"],
            samples_per_lane=v["render_samples_per_lane"],
            env_on_miss=v["render_env_on_miss"], env_nee=v["render_env_nee"],
            light_pick=v["render_light_pick"],
            debug_checks=v["render_debug_checks"],
        )
        return opts.replace(**overrides) if overrides else opts

    def camera(self, device="cuda") -> Camera:
        v = self.values
        return Camera.make(
            position=v["camera_position"], direction=v["camera_direction"],
            up=v["camera_up"], fov_deg=v["camera_fov"], device=device,
        )

    def save(self, path: str):
        """Reverse-sync to file (the reference's ``opt save``,
        App.cpp:446-457)."""
        with open(path, "w") as f:
            f.write("# terra_tpu_torch config\n")
            for k in sorted(self.values):
                val = self.values[k]
                if isinstance(val, tuple):
                    val = " ".join(str(x) for x in val)
                elif hasattr(val, "name"):
                    val = val.name.lower().replace("_", "-")
                f.write(f"{k} = {val}\n")


def load_config_file(path: str, config: Optional[Config] = None) -> Config:
    """Parse a ``key = value`` config file with ``#`` comments
    (Config.cpp:150-165)."""
    config = config or Config()
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            config.set(k.strip(), v.strip())
    return config


def find_config_file(name: str = DEFAULT_CONFIG_NAME) -> Optional[str]:
    """Search ./, ../, data/ like the reference (Config.cpp:150-165)."""
    for prefix in CONFIG_SEARCH_PATHS:
        p = os.path.join(prefix, name)
        if os.path.exists(p):
            return p
    return None
