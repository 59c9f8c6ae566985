"""Plain PyTorch reference of the path tracer the benchmark drives.

It implements, from the published algorithms and the system's documented
conventions, what a render pass computes for a (pixel, sample) lane:
Threefry-2x32-20 uniforms keyed by (seed, pixel, sample, bounce, stream),
the pinhole camera, Moller-Trumbore closest-hit and shadow queries (by
brute force or through a BVH the reference builds itself), the shading
surface recomputed from the triangle, bilinear textures, the diffuse and
GGX lobes, area-light next-event estimation (DIRECT), its power-2 MIS
with BSDF sampling (DIRECT_MIS), Russian roulette, and the film's
progressive sums. It imports nothing of the program and takes nothing it
made: it gets the scene arrays the benchmark generated and works out its
own light table, acceleration structure and keys.

Each lane is traced on its own path, one bounce after another, on the
lanes still alive (the program runs persistent lanes over every pixel;
the sum of a pixel's samples is the same). Operations follow the
system's documented order, so a sound program agrees with it to the bit
on nearly every lane; a lane whose discrete decision rounds the other
way differs, and the comparison allows for a small share of those.

``tf32=True`` is the control: every fetch from a table of at most 512
rows (materials, lights, a small scene's triangles) sees its values
rounded to TF32, as a one-hot product in TF32 would give them.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
T_FAR = 3.4e38
RAY_OFFSET_DIR = 1e-3
SURFACE_OFFSET_NORMAL = 1e-4
SHADOW_TMAX_SCALE = 1.0 - 1e-3
PDF_CLAMP = 1e17
EPS = 1e-4
SMALL_TABLE_ROWS = 512
PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
DEG2RAD = 0.0174533
DIFFUSE, GGX = 0, 2
DIRECT, DIRECT_MIS = 1, 2

# stream ids of the random decisions along a path
JITTER_X, BSDF_E0, BSDF_E1, BSDF_E2, ROULETTE = 0, 2, 3, 4, 5
LIGHT_PICK, LIGHT_U, LIGHT_V, MIS_E0, MIS_E1, MIS_E2 = 6, 8, 9, 10, 11, 12
ENV_U, ENV_V = 13, 14
ENV_H, ENV_W = 64, 128  # the environment proposal's lat-long grid
TWO_PI2 = float(np.float32(2.0 * np.pi * np.pi))


# ----------------------------------------------------------------- random
def key_from_seed(seed: int) -> tuple:
    """Two 32-bit key words of a seed by the splitmix64 finaliser."""
    mask = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return z & M32, z >> 32


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) on int64
    tensors holding 32-bit words."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for g in range(5):
        for r in rot[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ((ks[(g + 2) % 3] + g + 1) & M32)) & M32
    return x0, x1


def uniform_pair(key, pixel, sample, bounce, stream: int):
    """Uniforms of streams (stream, stream + 1), stream even: the two
    output words of one cipher call; counter (pixel, sample << 12 |
    bounce << 6 | stream), the top 24 bits over 2^24."""
    ctr = ((sample << 12) & M32) | ((bounce << 6) & M32) | stream
    b0, b1 = threefry2x32(key[0], key[1], pixel & M32, ctr)
    return ((b0 >> 8).float() * (1.0 / (1 << 24)), (b1 >> 8).float() * (1.0 / (1 << 24)))


def uniforms(key, pixel, sample, bounce, streams) -> dict:
    out = {}
    for base in sorted({s // 2 * 2 for s in streams}):
        out[base], out[base + 1] = uniform_pair(key, pixel, sample, bounce, base)
    return out


# ------------------------------------------------------------ vector math
def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def sqlen(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(sqlen(a))


def normalize(a):
    return a * torch.reciprocal(torch.sqrt(torch.clamp(sqlen(a), min=1e-20)))[..., None]


class _SqrtZeroGrad(torch.autograd.Function):
    """sqrt whose derivative at 0 is 0 (a sample at a lobe's pole)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, g * 0.5 / y, 0.0)


def reflect(wo, n):
    return 2.0 * dot(wo, n)[..., None] * n - wo


def basis(n):
    """Tangent and bitangent of a unit normal (local +Y the normal)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cond = torch.abs(nx) > torch.abs(ny)
    inv_a = torch.reciprocal(torch.sqrt(torch.where(cond, nx * nx + nz * nz, ny * ny + nz * nz)))
    zero = torch.zeros_like(nz)
    t = torch.stack([torch.where(cond, nz * inv_a, zero), torch.where(cond, zero, -nz * inv_a),
                     torch.where(cond, -nx * inv_a, ny * inv_a)], dim=-1)
    return t, cross(n, t)


def to_world(local, t, n, b):
    return local[..., 0:1] * t + local[..., 1:2] * n + local[..., 2:3] * b


def round_tf32(x):
    """Float32 values rounded to TF32's 10-bit mantissa, to nearest even;
    the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32).to(torch.int64)
    r = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(torch.float32)
    return x + (r - x).detach()


# ------------------------------------------------------------------ scene
class Scene:
    """The scene arrays as tensors on ``device``; ``positions``, ``attrs``
    and ``tex`` may be autograd leaves (``params``)."""

    def __init__(self, arrays: dict, device, accelerator: str, params=None, tf32=False):
        t = lambda x, dt=None: torch.as_tensor(np.asarray(x), device=device, dtype=dt)  # noqa: E731
        params = params or {}
        self.device, self.tf32 = device, tf32
        self.positions = params.get("positions", t(arrays["positions"]))
        self.vidx = t(arrays["tri_vidx"], torch.int64)
        self.normals = t(arrays["normals"])
        self.uvs = t(arrays["uvs"])
        self.mat_id = t(arrays["mat_id"], torch.int64)
        self.obj_id = t(arrays["obj_id"], torch.int64)
        self.bsdf_type = t(arrays["bsdf_type"], torch.int64)
        self.attrs = params.get("attrs", t(arrays["attrs"]))
        self.emissive = t(arrays["emissive"])
        self.ior = t(arrays["ior"])
        self.attr_tex = t(arrays["attr_tex"], torch.int64)
        self.emissive_tex = t(arrays["emissive_tex"], torch.int64)
        self.has_tex = arrays.get("tex_data") is not None
        if self.has_tex:
            self.tex = params.get("textures", t(arrays["tex_data"]))
            self.tex_size = t(arrays["tex_size"], torch.int64)
            self.tex_filter = t(arrays["tex_filter"], torch.int64)
            self.tex_address = t(arrays["tex_address"], torch.int64)
        ntri = arrays["tri_vidx"].shape[0]
        used = np.unique(arrays["bsdf_type"][np.unique(arrays["mat_id"])])
        unsupported = set(used.tolist()) - {DIFFUSE, GGX}
        if unsupported:
            raise ValueError(f"the reference has no lobe for BSDF types {sorted(unsupported)}")
        self.present = tuple(int(x) for x in used)
        self.tex_slots = tuple(s for s in range(8) if np.any(arrays["attr_tex"][:, s] >= 0)) \
            if self.has_tex else ()
        if np.any(arrays["emissive_tex"] >= 0):
            raise ValueError("the reference has no textured emission")
        # light table: every triangle whose material emits, in triangle order
        tri_em = arrays["emissive"][arrays["mat_id"]]
        lidx = np.nonzero(np.any(tri_em != 0.0, axis=-1))[0]
        self.light_tri = t(lidx, torch.int64)
        self.light_emissive = t(tri_em[lidx].astype(np.float32))
        self.num_lights = max(len(lidx), 1)
        self.small_tris = ntri <= SMALL_TABLE_ROWS
        self.bvh = None
        if accelerator == "bvh":
            corners = arrays["positions"][arrays["tri_vidx"]]
            self.bvh = Bvh(corners, device)
        elif accelerator != "brute":
            raise ValueError(f"unknown accelerator {accelerator!r}")

    def fetch(self, x, small: bool):
        """A table read: a small table's values come back with -0.0 as
        +0.0 (a one-hot product's sum), rounded to TF32 under the control."""
        if not small:
            return x
        return (round_tf32(x) if self.tf32 else x) + 0.0

    def corners(self, tri):
        v = self.vidx[tri]
        p = self.positions
        return (self.fetch(p[v[:, 0]], self.small_tris), self.fetch(p[v[:, 1]], self.small_tris),
                self.fetch(p[v[:, 2]], self.small_tris))

    def static_corners(self):
        with torch.no_grad():
            p = self.positions.detach()
            return p[self.vidx[:, 0]], p[self.vidx[:, 1]], p[self.vidx[:, 2]]


# ------------------------------------------------------------- raycasting
def mt(o, d, a, b, c, eps: float = 1e-4):
    """Moller-Trumbore (valid, t) with the arithmetic in component order."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az = a
    bx, by, bz = b
    cx, cy, cz = c
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok = torch.abs(det) > eps
    inv = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    return ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps), t


def _split(v):
    return v[..., 0], v[..., 1], v[..., 2]


def brute_closest(o, d, a, b, c):
    """Closest hit over every triangle, one dense (rays x triangles) grid;
    equal t goes to the lowest id. Returns (t, tri)."""
    oc = tuple(x[:, None] for x in _split(o))
    dc = tuple(x[:, None] for x in _split(d))
    tc = [tuple(x[None, :] for x in _split(v)) for v in (a, b, c)]
    valid, t = mt(oc, dc, *tc)
    best_t, best = torch.min(torch.where(valid, t, T_FAR), dim=1)
    return best_t, best


class Bvh:
    """A binary BVH of the reference's own: triangles sorted by the Morton
    code of their centroids, each node's range split at its middle, four
    triangles a leaf. Built with NumPy; walked per ray with a stack. Its
    boxes are grown by a few ulps of the scene's extent, so no rounding in
    the slab test culls a hit, and of hits at equal t the lowest triangle
    id wins: the closest hit of the brute-force sweep, whatever the tree."""

    LEAF = 4

    def __init__(self, corners: np.ndarray, device):
        lo, hi = corners.min(axis=1), corners.max(axis=1)
        cen = 0.5 * (lo + hi)
        span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
        q = np.clip(((cen - cen.min(0)) / span * 1023).astype(np.int64), 0, 1023)
        code = np.zeros(len(q), np.int64)
        for bit in range(10):
            for ax in range(3):
                code |= ((q[:, ax] >> bit) & 1) << (3 * bit + (2 - ax))
        order = np.argsort(code, kind="stable")
        starts, counts, left = [0], [len(order)], [-1]
        level = [0]
        while level:
            nxt = []
            for node in level:
                s, n = starts[node], counts[node]
                if n <= self.LEAF:
                    continue
                half = n // 2
                left[node] = len(starts)
                for cs, cn in ((s, half), (s + half, n - half)):
                    starts.append(cs)
                    counts.append(cn)
                    left.append(-1)
                    nxt.append(len(starts) - 1)
            level = nxt
        starts, counts, left = map(np.asarray, (starts, counts, left))
        nn = len(starts)
        bmin = np.empty((nn, 3), np.float32)
        bmax = np.empty((nn, 3), np.float32)
        leaf = left < 0
        # leaves in range order tile the sorted triangles: one reduceat each
        lf = np.nonzero(leaf)[0]
        lf = lf[np.argsort(starts[lf])]
        bmin[lf] = np.minimum.reduceat(lo[order], starts[lf])
        bmax[lf] = np.maximum.reduceat(hi[order], starts[lf])
        for node in np.nonzero(~leaf)[0][::-1]:
            l_, r_ = left[node], left[node] + 1
            bmin[node] = np.minimum(bmin[l_], bmin[r_])
            bmax[node] = np.maximum(bmax[l_], bmax[r_])
        pad = np.float32(np.abs(corners).max() * 2.0 ** -16)
        bmin, bmax = bmin - pad, bmax + pad
        tri = np.full((nn, self.LEAF), -1, np.int64)
        for k in range(self.LEAF):
            m = leaf & (counts > k)
            tri[m, k] = order[starts[m] + k]
        dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        self.bmin, self.bmax, self.left = dev(bmin), dev(bmax), dev(left)
        self.leaf_tris = dev(tri)
        depth, n = 0, len(order)
        while n > self.LEAF:
            n, depth = (n + 1) // 2, depth + 1
        self.stack = depth + 2

    def query(self, o, d, a, b, c, t_max=None):
        """Closest hit (t, tri) of each ray, or with ``t_max`` whether a
        triangle lies at t < t_max (t then the first found, tri unused).
        Children's boxes are tested at their parent and pushed far first,
        each with its entry distance, so a node popped behind a closer hit
        is skipped."""
        n = o.shape[0]
        dev = o.device
        best_t = torch.full((n,), T_FAR, device=dev) if t_max is None else t_max.clone()
        best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
        safe = torch.where(torch.abs(d) < 1e-30, torch.full_like(d, 1e-30), d)
        inv = 1.0 / safe
        stack = torch.zeros((n, 2 * self.stack), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((n, 2 * self.stack), device=dev)
        sp = torch.ones((n,), dtype=torch.int64, device=dev)
        ids = torch.arange(n, device=dev)
        self.iterations = 0
        while ids.numel():  # every step masked: one host read a step, the compaction
            self.iterations += 1
            top = sp[ids] - 1
            node = stack[ids, top]
            bt, bi = best_t[ids], best_i[ids]
            live = stack_t[ids, top] <= bt
            lnode = self.left[node]
            # a leaf's triangles (an inner node's row is all -1)
            tris = self.leaf_tris[node]
            ok = (tris >= 0) & live[:, None]
            tri = torch.where(ok, tris, 0)
            cc = [_split(v[tri]) for v in (a, b, c)]
            oc = tuple(x[:, None] for x in _split(o[ids]))
            dc = tuple(x[:, None] for x in _split(d[ids]))
            valid, t = mt(oc, dc, *cc)
            t = torch.where(valid & ok, t, T_FAR)
            tb = torch.amin(t, dim=1)
            # of the leaf's hits at its least t, the lowest id
            ti = torch.amin(torch.where(t == tb[:, None], tri, 1 << 62), dim=1)
            take = (tb < bt) | ((tb == bt) & (tb < T_FAR) & (ti < bi))
            bt = torch.where(take, tb, bt)
            best_t[ids] = bt
            best_i[ids] = torch.where(take, ti, bi)
            spn = top if t_max is None else torch.where(take, 0, top)
            # an inner node's children, tested here, pushed far first
            inner = live & (lnode >= 0)
            ch = torch.clamp(lnode, min=0)[:, None] + torch.arange(2, device=dev)
            oo, ii = o[ids][:, None], inv[ids][:, None]
            t1 = (self.bmin[ch] - oo) * ii
            t2 = (self.bmax[ch] - oo) * ii
            tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
            tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
            enter = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin <= bt[:, None]) & inner[:, None]
            far = (tmin[:, 1] < tmin[:, 0]).long()
            for slot in (far, 1 - far):
                e = enter.gather(1, slot[:, None])[:, 0]
                at = (ids, spn)
                stack[at] = torch.where(e, ch.gather(1, slot[:, None])[:, 0], stack[at])
                stack_t[at] = torch.where(e, tmin.gather(1, slot[:, None])[:, 0], stack_t[at])
                spn = spn + e.long()
            sp[ids] = spn
            ids = ids[spn > 0]
        return best_t, best_i


def raycast(scene: Scene, o, d, t_max=None):
    """(hit, tri) of rays, origins nudged along d first; with ``t_max``
    ``hit`` means occluded within it."""
    with torch.no_grad():
        o = o.detach() + d.detach() * RAY_OFFSET_DIR
        d = d.detach()
        a, b, c = scene.static_corners()
        if scene.small_tris and scene.tf32:
            a, b, c = round_tf32(a), round_tf32(b), round_tf32(c)
        if scene.bvh is None:
            best_t, best_i = brute_closest(o, d, a, b, c)
        else:
            best_t, best_i = scene.bvh.query(o, d, a, b, c, t_max)
        hit = best_t < (T_FAR if t_max is None else t_max)
        return hit, torch.where(hit, best_i, 0)


# ---------------------------------------------------------------- surface
def texture(scene: Scene, tex_id, uv):
    """Bilinear or point sample of per-lane textures (wrap, mirror, clamp)."""
    h = scene.tex_size[tex_id, 0]
    w = scene.tex_size[tex_id, 1]
    mode = scene.tex_address[tex_id]
    fx = uv[..., 0] * w.float()
    fy = uv[..., 1] * h.float()
    ix = torch.floor(fx).long()
    iy = torch.floor(fy).long()

    def address(c, size):
        size = torch.clamp(size, min=1)
        wrap = torch.remainder(c, size)
        m = torch.remainder(c, 2 * size)
        mirror = torch.where(m >= size, 2 * size - 1 - m, m)
        clamp = torch.minimum(torch.clamp(c, min=0), size - 1)
        return torch.where(mode == 0, wrap, torch.where(mode == 1, mirror, clamp))

    nt, H, W, _ = scene.tex.shape
    flat_tex = scene.tex.reshape(nt * H * W, 3)

    def read(x, y):
        return flat_tex[(tex_id * H + address(y, h)) * W + address(x, w)]

    n1, n2, n3, n4 = read(ix, iy), read(ix + 1, iy), read(ix, iy + 1), read(ix + 1, iy + 1)
    wu = (fx - ix.float())[..., None]
    wv = (fy - iy.float())[..., None]
    bil = (n1 * (1 - wu) + n2 * wu) * (1 - wv) + (n3 * (1 - wu) + n4 * wu) * wv
    return torch.where((scene.tex_filter[tex_id] == 1)[..., None], bil, n1)


class Surf:
    pass


def surface(scene: Scene, o, d, tri):
    """The shading surface of lanes that hit ``tri`` along (o, d): the hit
    point by ray/plane intersection, barycentrics by the 2x2 normal
    equations, interpolated normal and uv, the material with textures."""
    va, vb, vc = scene.corners(tri)
    small = scene.small_tris
    nr = scene.fetch(scene.normals[tri], small)
    uvr = scene.fetch(scene.uvs[tri], small)
    e0 = vb - va
    e1 = vc - va
    ng = cross(e0, e1)
    den = dot(d, ng)
    ok = torch.abs(den) > 1e-12
    t = dot(va - o, ng) / torch.where(ok, den, 1.0)
    t = torch.where(ok, t, 0.0)
    point = o + t[..., None] * d
    p = point - va
    d00, d11, d01 = dot(e0, e0), dot(e1, e1), dot(e0, e1)
    dp0, dp1 = dot(p, e0), dot(p, e1)
    div = d00 * d11 - d01 * d01
    inv_div = torch.reciprocal(torch.where(torch.abs(div) > 1e-20, div, 1.0))
    wb = (d11 * dp0 - d01 * dp1) * inv_div
    wc = (d00 * dp1 - d01 * dp0) * inv_div
    wa = 1.0 - wb - wc
    s = Surf()
    s.normal = normalize(wa[..., None] * nr[:, 0] + wb[..., None] * nr[:, 1]
                         + wc[..., None] * nr[:, 2])
    s.uv = wa[..., None] * uvr[:, 0] + wb[..., None] * uvr[:, 1] + wc[..., None] * uvr[:, 2]
    mid = scene.mat_id[tri]
    s.bsdf_type = scene.bsdf_type[mid]
    s.ior = scene.fetch(scene.ior[mid], True)
    s.emissive = scene.fetch(scene.emissive[mid], True)
    attrs = scene.fetch(scene.attrs[mid], True)
    if scene.has_tex and scene.tex_slots:
        cols = []
        for k in range(8):
            a = attrs[:, k, :]
            if k in scene.tex_slots:
                tid = scene.attr_tex[mid, k]
                a = torch.where((tid >= 0)[..., None],
                                texture(scene, torch.clamp(tid, min=0), s.uv), a)
            cols.append(a)
        attrs = torch.stack(cols, dim=-2)
    s.attrs = attrs
    s.point, s.t = point, t
    s.obj_id = scene.obj_id[tri]
    s.tri_area = 0.5 * length(ng)
    s.tangent, s.bitangent = basis(s.normal)
    return s


# ------------------------------------------------------------------- BSDF
def _cosine(s, e1, e2):
    r = torch.sqrt(e1)
    th = 2.0 * PI * e2
    local = torch.stack([r * torch.cos(th), torch.sqrt(torch.clamp(1.0 - e1, min=0.0)),
                         r * torch.sin(th)], dim=-1)
    return normalize(to_world(local, s.tangent, s.normal, s.bitangent))


def _diffuse_pdf(s, wi):
    return torch.clamp(dot(s.normal, wi), min=0.0) * INV_PI


def _ggx(s):
    rough = torch.clamp(s.attrs[..., 1, 0], 1e-3, 1.0)
    metal = torch.clamp(s.attrs[..., 2, 0], 0.0, 1.0)
    return s.attrs[..., 0, :], metal, rough * rough


def _pick_diffuse(metal):
    return torch.clamp(1.0 - metal * 0.5 - 0.25, 0.05, 0.95)


def _ggx_d(noh, alpha):
    a2 = alpha * alpha
    den = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * den * den, min=1e-8)


def _g1(nov, alpha):
    a2 = alpha * alpha
    return 2.0 * nov / torch.clamp(nov + torch.sqrt(a2 + (1.0 - a2) * nov * nov), min=1e-8)


def _schlick(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _select(s, results: dict):
    types = [t for t in s.present if t in results]
    out = results[types[0]]
    for ty in types[1:]:
        mask = s.bsdf_type == ty
        r = results[ty]
        out = torch.where(mask[..., None] if r.dim() > mask.dim() else mask, r, out)
    return out


def bsdf_sample(s, e0, e1, e2, wo):
    res = {}
    if DIFFUSE in s.present:
        res[DIFFUSE] = _cosine(s, e0, e1)
    if GGX in s.present:
        _, metal, alpha = _ggx(s)
        take = e2 < _pick_diffuse(metal)
        wd = _cosine(s, e0, e1)
        tan_t = alpha * torch.sqrt(e0) / torch.sqrt(torch.clamp(1.0 - e0, min=1e-8))
        cos_t = torch.reciprocal(torch.sqrt(1.0 + tan_t * tan_t))
        sin_t = _SqrtZeroGrad.apply(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * PI * e1
        lh = torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)], dim=-1)
        h = normalize(to_world(lh, s.tangent, s.normal, s.bitangent))
        res[GGX] = torch.where(take[..., None], wd, normalize(reflect(wo, h)))
    return _select(s, res)


def bsdf_pdf(s, wi, wo):
    res = {}
    if DIFFUSE in s.present:
        res[DIFFUSE] = _diffuse_pdf(s, wi)
    if GGX in s.present:
        _, metal, alpha = _ggx(s)
        pd = _pick_diffuse(metal)
        h = normalize(wi + wo)
        noh = torch.clamp(dot(s.normal, h), min=0.0)
        hov = torch.clamp(dot(h, wo), min=1e-6)
        spec = _ggx_d(noh, alpha) * noh / (4.0 * hov)
        res[GGX] = pd * _diffuse_pdf(s, wi) + (1.0 - pd) * spec
    return _select(s, res)


def bsdf_eval(s, wi, wo):
    res = {}
    if DIFFUSE in s.present:
        res[DIFFUSE] = s.attrs[..., 0, :] * INV_PI
    if GGX in s.present:
        albedo, metal, alpha = _ggx(s)
        n = s.normal
        nol = torch.clamp(dot(n, wi), min=1e-6)
        nov = torch.clamp(dot(n, wo), min=1e-6)
        h = normalize(wi + wo)
        noh = torch.clamp(dot(n, h), min=0.0)
        loh = torch.clamp(dot(wi, h), min=0.0)
        f = (1.0 - s.ior) / (1.0 + s.ior)
        f0 = (f * f)[..., None] * torch.ones_like(albedo)
        f0 = f0 + (albedo - f0) * metal[..., None]
        F = f0 + (1.0 - f0) * _schlick(loh)[..., None]
        G = _g1(nol, alpha) * _g1(nov, alpha)
        spec = F * (_ggx_d(noh, alpha) * G / (4.0 * nol * nov))[..., None]
        res[GGX] = spec + albedo * INV_PI * (1.0 - metal)[..., None] * (1.0 - F)
    return _select(s, res)



# ------------------------------------------------------------ environment
class Env:
    """A constant environment and its sampling proposal: the lat-long grid
    of luminance x sin(theta) plus a floor of 1% of its mean, a marginal
    over rows and a conditional per row, each an inclusive cumulative sum
    over its total."""

    def __init__(self, scene: Scene, value):
        dev = scene.device
        self.scene = scene
        self.value = torch.as_tensor(np.asarray(value, np.float32), device=dev)
        lum = 0.2126 * self.value[0] + 0.7152 * self.value[1] + 0.0722 * self.value[2]
        theta = ((torch.arange(ENV_H, dtype=torch.float32, device=dev) + 0.5) / ENV_H) * PI
        sin_t = torch.sin(theta)[:, None]
        f = lum.expand(ENV_H, ENV_W) * sin_t
        floor = torch.clamp(f.mean(), min=1e-12) * 1e-2
        self.f = f + floor * sin_t
        c = torch.cumsum(self.f, dim=-1)
        self.integral = c[..., -1]
        self.cdf = c / torch.clamp(self.integral, min=1e-20)[..., None]
        mc = torch.cumsum(self.integral, dim=-1)
        self.m_integral = mc[-1]
        self.m_cdf = mc / torch.clamp(self.m_integral, min=1e-20)

    def radiance(self, d):
        return self.value.expand(d.shape)

    def sample(self, e1, e2):
        """A direction from the proposal and its solid-angle pdf."""
        fetch = self.scene.fetch
        n = ENV_H
        row = torch.clamp(torch.searchsorted(self.m_cdf, e1, right=True), 0, n - 1)
        prev_cdf = torch.cat([torch.zeros_like(self.m_cdf[:1]), self.m_cdf[:-1]])
        curr, prev = fetch(self.m_cdf[row], True), fetch(prev_cdf[row], True)
        f_at = fetch(self.integral[row], True)
        v = (row.float() + (e1 - prev) / torch.clamp(curr - prev, min=1e-12)) / n
        pdf_y = f_at / torch.clamp(self.m_integral, min=1e-20)
        cdf, fr = fetch(self.cdf[row], True), fetch(self.f[row], True)
        integ = fetch(self.integral[row], True)
        idx = torch.clamp((cdf < e2[..., None]).sum(dim=-1), 0, ENV_W - 1)
        at = lambda t, i: t.gather(1, i[:, None])[:, 0]  # noqa: E731
        prev = torch.where(idx > 0, at(cdf, torch.clamp(idx - 1, min=0)), 0.0)
        curr = at(cdf, idx)
        u = (idx.float() + (e2 - prev) / torch.clamp(curr - prev, min=1e-12)) / ENV_W
        pdf = pdf_y * (at(fr, idx) / torch.clamp(integ, min=1e-20))
        theta = v * PI
        phi = u * (2.0 * PI) - PI
        sin_t = torch.sin(theta)
        wi = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)
        return wi, pdf * float(ENV_W * ENV_H) / torch.clamp(TWO_PI2 * sin_t, min=1e-6)

    def pdf(self, wi):
        d = normalize(wi)
        theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
        phi = torch.atan2(d[..., 2], d[..., 0]) + PI
        col = torch.clamp(((phi / (2.0 * PI)) * ENV_W).to(torch.int64), 0, ENV_W - 1)
        row = torch.clamp(((theta / PI) * ENV_H).to(torch.int64), 0, ENV_H - 1)
        f_at = self.scene.fetch(self.f[row], True).gather(1, col[:, None])[:, 0]
        density = f_at * float(ENV_W * ENV_H) / torch.clamp(self.m_integral, min=1e-20)
        return density / (TWO_PI2 * torch.clamp(torch.sin(theta), min=1e-6))


def _nee_env(scene, env: Env, s, wo, u):
    wi, env_pdf = env.sample(u[ENV_U], u[ENV_V])
    nol = dot(wi, s.normal)
    hit, _ = raycast(scene, _shadow_origin(s), wi)
    visible = ~hit & (nol > 0.0) & (env_pdf > 0.0)
    f = bsdf_eval(s, wi, wo)
    weight = _power2(env_pdf, bsdf_pdf(s, wi, wo))
    den = torch.where(visible, env_pdf, 1.0)
    c = env.radiance(wi) * f * (nol * weight / den)[..., None]
    return torch.where(visible[..., None], c, 0.0)


def _mis_env(env: Env, s, wi, f, pdf, hit):
    """The escaping MIS BSDF sample's environment term."""
    env_pdf = env.pdf(wi)
    nol = dot(wi, s.normal)
    ok = ~hit & (pdf > 0.0) & (nol > 0.0)
    weight = _power2(pdf, env_pdf)
    den = torch.where(ok, pdf, 1.0)
    c = env.radiance(wi) * f * (nol * weight / den)[..., None]
    return torch.where(ok[..., None], c, 0.0)

# ------------------------------------------------------------- integrator
def _power2(pa, pb):
    pa = torch.clamp(pa, max=PDF_CLAMP)
    pb = torch.clamp(pb, max=PDF_CLAMP)
    return (pa * pa) / torch.clamp(pa * pa + pb * pb, min=1e-20)


def _light_sample(scene: Scene, u_pick, e1, e2):
    """A light triangle picked uniformly, a uniform point on it. The light
    rows (corners, normals, area, emission) are one small table."""
    num = scene.num_lights
    slot = torch.clamp((u_pick * float(num)).to(torch.int32), max=num - 1).long()
    ltri = scene.light_tri[slot]
    v = scene.vidx[ltri]
    p = scene.positions
    a, b, c = p[v[:, 0]], p[v[:, 1]], p[v[:, 2]]
    area = scene.fetch(0.5 * length(cross(b - a, c - a)), True)
    a, b, c = scene.fetch(a, True), scene.fetch(b, True), scene.fetch(c, True)
    nr = scene.fetch(scene.normals[ltri], True)
    sq = torch.sqrt(e1)
    wa = 1.0 - sq
    wb = e2 * sq
    wc = 1.0 - wa - wb
    pos = wa[..., None] * a + wb[..., None] * b + wc[..., None] * c
    normal = normalize(wa[..., None] * nr[:, 0] + wb[..., None] * nr[:, 1]
                       + wc[..., None] * nr[:, 2])
    em = scene.fetch(scene.light_emissive[slot], True)
    return ltri, pos, normal, area, torch.ones_like(u_pick) / float(num), em


def _shadow_origin(s):
    return s.point + s.normal * 1e-4


def _nee_light(scene, s, wo, u, want_weight: bool):
    ltri, pos, lnormal, area, pick_pdf, em = _light_sample(scene, u[LIGHT_PICK], u[LIGHT_U],
                                                           u[LIGHT_V])
    p_to = pos - s.point
    wi = normalize(p_to)
    o_sh = _shadow_origin(s)
    t_light = length(pos - o_sh) * SHADOW_TMAX_SCALE
    occ, _ = raycast(scene, o_sh, wi, t_max=t_light.detach())
    cos_l = dot(lnormal, -wi)
    visible = ~occ & (cos_l > 0.0)
    light_pdf = sqlen(p_to) / torch.clamp(torch.abs(cos_l * area), min=1e-12)
    f = bsdf_eval(s, wi, wo)
    nol = dot(wi, s.normal)
    if want_weight:
        weight = _power2(light_pdf, bsdf_pdf(s, wi, wo))
        visible = visible & (light_pdf != 0.0)
    else:
        weight = torch.ones_like(light_pdf)
    den = torch.where(visible, light_pdf * pick_pdf, 1.0)
    c = em * f * (nol * weight / den)[..., None]
    return torch.where(visible[..., None], c, 0.0), ltri


def _mis_bsdf(scene, s, wo, u, ltri, env=None):
    wi = bsdf_sample(s, u[MIS_E0], u[MIS_E1], u[MIS_E2], wo)
    f = bsdf_eval(s, wi, wo)
    pdf = bsdf_pdf(s, wi, wo)
    o_sh = _shadow_origin(s)
    hit, tri = raycast(scene, o_sh, wi)
    hs = surface(scene, o_sh + wi * 1e-3, wi, tri)
    same = hs.obj_id == scene.obj_id[ltri]
    now = dot(hs.normal, -wi)
    ok = hit & same & (now > 0.0)
    light_pdf = sqlen(hs.point - s.point) / torch.clamp(now * hs.tri_area, min=1e-12)
    weight = _power2(pdf, light_pdf)
    ok = ok & (pdf != 0.0)
    nol = dot(wi, s.normal)
    den = torch.where(ok, pdf, 1.0)
    c = hs.emissive * f * (nol * weight / den)[..., None]
    c = torch.where(ok[..., None], c, 0.0)
    if env is not None:
        c = c + _mis_env(env, s, wi, f, pdf, hit)
    return c


def streams(integrator: int, env: bool = False) -> tuple:
    extra = (LIGHT_PICK, LIGHT_U, LIGHT_V)
    if integrator == DIRECT_MIS:
        extra = (MIS_E0, MIS_E1, MIS_E2) + extra
    if env:
        extra = extra + (ENV_U, ENV_V)
    return (BSDF_E0, BSDF_E1, BSDF_E2, ROULETTE) + extra


def camera_rays(cam: dict, width: int, height: int, jitter: float, px, py, r1, r2, device):
    """Pinhole camera rays (left-handed, Y-up, looking down +Z)."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
    pos, dirn, up, fov = (f32(cam[k]) for k in ("position", "direction", "up", "fov_deg"))
    dx = -jitter + 2.0 * r1 * jitter
    dy = -jitter + 2.0 * r2 * jitter
    sx = 2.0 * ((px.float() + 0.5 + dx) / float(width)) - 1.0
    sy = 1.0 - 2.0 * ((py.float() + 0.5 + dy) / float(height))
    aspect = float(np.float32(width / height))
    tan_half = torch.tan(fov * DEG2RAD / 2.0)
    local = normalize(torch.stack([sx * aspect * tan_half, sy * tan_half, torch.ones_like(sx)],
                                  dim=-1))
    z = normalize(dirn)
    x = normalize(cross(up, z))
    y = cross(z, x)
    d = local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * z
    return pos.expand(d.shape), d


def trace(scene: Scene, opts: dict, cam: dict, key, pixel, sample):
    """(N, 3) radiance of each (pixel, sample) lane: one path of at most
    ``bounces + 1`` segments. ``key``: a pair of key words, each an int or
    an (N,) int64 tensor. With ``opts["env"]`` a constant environment
    lights the scene: rays that leave it at the camera see it, and every
    shaded point samples it (DIRECT_MIS's third strategy, with the BSDF
    sample's escape its MIS counterpart). Differentiable in the scene's
    parameters when they require a gradient."""
    dev = pixel.device
    width, height = int(opts["width"]), int(opts["height"])
    integ = {"direct": DIRECT, "direct_mis": DIRECT_MIS}[opts["integrator"]]
    rr_start = int(opts.get("rr_start_bounce", 0))
    r1, r2 = uniform_pair(key, pixel, sample, 0, JITTER_X)
    o, d = camera_rays(cam, width, height, float(opts["subpixel_jitter"]), pixel % width,
                       pixel // width, r1, r2, dev)
    n = pixel.shape[0]
    lo = torch.zeros((n, 3), device=dev)
    tp = torch.ones((n, 3), device=dev)
    ids = torch.arange(n, device=dev)
    env = Env(scene, opts["env"]) if opts.get("env") is not None else None
    if env is not None and integ != DIRECT_MIS:
        raise ValueError("the reference lights by an environment under DIRECT_MIS only")
    sts = streams(integ, env is not None)
    for bounce in range(int(opts["bounces"]) + 1):
        u = uniforms(tuple(k[ids] if isinstance(k, torch.Tensor) else k for k in key),
                     pixel[ids], sample[ids], bounce, sts)
        hit, tri = raycast(scene, o, d)
        if env is not None and bounce == 0:  # camera rays that leave the scene
            miss = ~hit
            lo = lo.index_add(0, ids[miss], tp[miss] * env.radiance(d[miss]))
        keep = hit.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        ids, o, d, tp, tri = ids[keep], o[keep], d[keep], tp[keep], tri[keep]
        u = {k: v[keep] for k, v in u.items()}
        s = surface(scene, o + d * RAY_OFFSET_DIR, d, tri)
        s.present = scene.present
        wo = -d
        facing = (dot(wo, s.normal) > 0.0) & (bounce == 0)
        rad = torch.where(facing[..., None], s.emissive, 0.0)
        light_c, ltri = _nee_light(scene, s, wo, u, integ == DIRECT_MIS)
        rad = rad + light_c
        if integ == DIRECT_MIS:
            rad = rad + _mis_bsdf(scene, s, wo, u, ltri, env)
        if env is not None:
            rad = rad + _nee_env(scene, env, s, wo, u)
        lo = lo.index_add(0, ids, rad * tp)
        wi = bsdf_sample(s, u[BSDF_E0], u[BSDF_E1], u[BSDF_E2], wo)
        pdf = torch.clamp(bsdf_pdf(s, wi, wo), min=EPS)
        f = bsdf_eval(s, wi, wo)
        new_tp = tp * f * (dot(s.normal, wi) / pdf)[..., None]
        alive = torch.ones_like(pdf, dtype=torch.bool)
        if bounce >= rr_start:
            p = torch.amax(new_tp, dim=-1)
            alive = u[ROULETTE] <= p
            new_tp = new_tp / (p + EPS)[..., None]
        keep = alive.nonzero()[:, 0]
        ids = ids[keep]
        o = (s.point + s.normal * SURFACE_OFFSET_NORMAL)[keep]
        d, tp = wi[keep], new_tp[keep]
        if ids.numel() == 0:
            break
    return lo


def film_values(scene: Scene, opts: dict, cam: dict, pass_seeds, pixels, spp: int,
                checkpoints, chunk: int = 1 << 19):
    """Developed image values at ``pixels`` (a (K,) tensor of flat pixel
    ids) after each pass in ``checkpoints`` of a progressive film fed
    ``spp`` samples a pass by the passes of ``pass_seeds``: a pass's sum
    adds its samples in order, the film adds each pass's sum, the image is
    the film over its sample count. Returns {pass index: (K, 3)}."""
    dev = pixels.device
    k = pixels.shape[0]
    last = max(checkpoints)
    keys = torch.as_tensor([key_from_seed(s) for s in pass_seeds[:last + 1]], dtype=torch.int64,
                           device=dev)
    per = max(chunk // (k * spp), 1)
    out = {}
    film = torch.zeros((k, 3), device=dev)
    for j0 in range(0, last + 1, per):
        js = torch.arange(j0, min(j0 + per, last + 1), device=dev)
        lane_j = js.repeat_interleave(k * spp)
        lane_px = pixels.repeat_interleave(spp).repeat(js.shape[0])
        lane_s = lane_j * spp + torch.arange(spp, device=dev).repeat(k * js.shape[0])
        kk = keys[lane_j]
        rad = trace(scene, opts, cam, (kk[:, 0], kk[:, 1]), lane_px, lane_s)
        rad = rad.reshape(js.shape[0], k, spp, 3)
        for jj, j in enumerate(js.tolist()):
            acc = torch.zeros((k, 3), device=dev)
            for i in range(spp):
                acc = acc + rad[jj, :, i]
            film = film + acc
            if j in checkpoints:  # a true division, as by the film's count
                out[j] = film / torch.full((k, 1), float((j + 1) * spp), device=dev)
    return out
