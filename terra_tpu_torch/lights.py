"""Area-light sampling over the flattened emissive-triangle table (port of
``terra_tpu/lights.py``): pick a light triangle uniformly (pdf 1/L, the
reference's) or by the area CDF, then a uniform point on it. Each lane
fetches its light's data as one row of ``ShadeTables.light``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops import math3
from .scene import Scene
from .surface import fetch_rows

__all__ = ["LightSample", "pick_and_sample"]


@dataclass
class LightSample:
    tri_idx: torch.Tensor   # (N,) i32 triangle of the sampled light
    pos: torch.Tensor       # (N, 3) sampled point
    normal: torch.Tensor    # (N, 3) interpolated light normal
    uv: torch.Tensor        # (N, 2)
    area: torch.Tensor      # (N,) area of the sampled triangle
    pick_pdf: torch.Tensor  # (N,) probability of picking the triangle
    area_pdf: torch.Tensor  # (N,) 1/area
    emissive: torch.Tensor  # (N, 3) radiance at the sampled point


def pick_and_sample(scene: Scene, e_pick, e1, e2, table, area_weighted: bool = False) -> LightSample:
    """``e_pick``, ``e1``, ``e2``: (N,) uniforms; ``table``: the (Lcap, 30)
    light row table of ``surface.build_shade_tables``."""
    lights = scene.lights
    num = max(lights.num, 1)
    if area_weighted:
        slot = torch.searchsorted(lights.cdf, e_pick).to(torch.int32)
        slot = torch.clamp(slot, max=num - 1)
        live = torch.arange(lights.area.shape[0], device=e_pick.device) < num
        total_area = torch.sum(torch.where(live, lights.area, 0.0))
        pick_pdf = lights.area[slot.long()] / torch.clamp(total_area, min=1e-12)
    else:
        slot = torch.clamp((e_pick * float(num)).to(torch.int32), max=num - 1)
        pick_pdf = torch.ones_like(e_pick) / float(num)

    # uniform in triangle: wa = 1 - sqrt(e1), wb = e2 sqrt(e1), wc = 1 - wa - wb
    s = torch.sqrt(e1)
    wa = 1.0 - s
    wb = e2 * s
    wc = 1.0 - wa - wb

    row = fetch_rows(table, slot)
    a, b, c = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    area = row[:, 24]
    emissive = row[:, 25:28]
    tri_idx = torch.round(row[:, 28]).to(torch.int32)
    etid = torch.round(row[:, 29]).to(torch.int32)
    pos = wa[..., None] * a + wb[..., None] * b + wc[..., None] * c
    normal = math3.normalize(wa[..., None] * n0 + wb[..., None] * n1 + wc[..., None] * n2)
    uv = wa[..., None] * uv0 + wb[..., None] * uv1 + wc[..., None] * uv2
    if scene.textures.num_textures > 0 and scene.materials.emissive_textured:
        from . import textures

        tex = textures.sample(scene.textures, torch.clamp(etid, min=0), uv)
        emissive = torch.where((etid >= 0)[..., None], tex, emissive)
    return LightSample(tri_idx=tri_idx, pos=pos, normal=normal, uv=uv, area=area,
                       pick_pdf=pick_pdf,
                       area_pdf=torch.reciprocal(torch.clamp(area, min=1e-12)),
                       emissive=emissive)
