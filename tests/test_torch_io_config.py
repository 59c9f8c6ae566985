"""The port's OBJ/MTL import, image I/O, option registry and command line
against terra_tpu's, on the CPU.

Twins of every test in tests/test_io_config.py run against the port
(``device="cpu"``, ``--device cpu``). Beyond them: ``load_obj`` gives the
reference's arrays bit for bit (NumPy does the arithmetic in both, in the
same order); the port's PNG codec decodes to Pillow's bytes for every
colour type and row filter it supports and works with Pillow blocked;
config files cross between the packages; the two command lines render the
same film under tests/test_golden.py's twin budgets; and a scene exported
to OBJ + MTL + PNG loads back to the scene's own arrays.
"""
import argparse
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from terra_tpu import cli as jcli
from terra_tpu.config import Config as JConfig, load_config_file as jload_config_file
from terra_tpu.io.obj import load_obj as jload_obj
import terra_tpu_torch as ttt
from terra_tpu_torch import cli, native
from terra_tpu_torch.checkpoint import load_render_state, save_render_state
from terra_tpu_torch.config import Config, load_config_file
from terra_tpu_torch.film import Film
from terra_tpu_torch.io import image as image_mod
from terra_tpu_torch.io import obj as obj_mod
from terra_tpu_torch.io.image import load_image, read_png, save_image
from terra_tpu_torch.io.obj import load_obj
from tests.test_golden import _assert_twin_match
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOX_MTL = """\
newmtl white
Kd 0.7 0.7 0.7
illum diffuse
newmtl lamp
Kd 0 0 0
Ke 10 10 10
newmtl shiny
Kd 0.2 0.2 0.2
Ks 0.8 0.8 0.8
Ns 64
illum specular
newmtl metal
Kd 0.9 0.5 0.3
Pr 0.2
Pm 1.0
"""
BOX_OBJ = """\
mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
o quad
usemtl white
f 1/1/1 2/2/1 3/3/1 4/4/1
o lamp
usemtl lamp
f 1/1/1 3/3/1 4/4/1
o shiny
usemtl shiny
f 1 2 3
o metal
usemtl metal
f 2 3 4
"""


@pytest.fixture
def obj_scene(tmp_path):
    """tests/test_io_config.py's fixture: four materials, a polygon face."""
    (tmp_path / "box.mtl").write_text(BOX_MTL)
    (tmp_path / "box.obj").write_text(BOX_OBJ)
    return tmp_path / "box.obj"


@pytest.fixture
def textured_obj_scene(obj_scene):
    """The fixture with a Pillow-written PNG as the white material's map_Kd."""
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)).save(
        obj_scene.parent / "wood.png")
    mtl = obj_scene.parent / "box.mtl"
    mtl.write_text(mtl.read_text().replace("illum diffuse", "illum diffuse\nmap_Kd wood.png"))
    return obj_scene


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_arrays(port, ref, fields):
    for f in fields:
        a, b = _np(getattr(port, f)), _np(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f"{f} differs"


GEOMETRY = ("positions", "tri_vidx", "normals", "uvs", "mat_id", "obj_id")
MATERIALS = ("bsdf_type", "attrs", "attr_tex", "emissive", "emissive_tex", "ior")
ATLAS = ("data", "size", "filter", "address")


# -- twins of tests/test_io_config.py ---------------------------------------

def test_load_obj(obj_scene):
    geom, mats, atlas = load_obj(str(obj_scene), device="cpu")
    assert geom.num_triangles == 5  # quad fans into 2 + 3 single tris
    assert atlas.num_textures == 0
    types = {int(t) for t in _np(mats.bsdf_type)}
    assert types == {int(ttt.BSDFType.DIFFUSE), int(ttt.BSDFType.PHONG), int(ttt.BSDFType.GGX)}
    em = _np(mats.emissive)
    assert (em.max(axis=-1) > 0).sum() == 1  # only the lamp emits
    assert _np(geom.positions)[:, 2].max() == 0.0  # handedness flip negates z
    assert len(np.unique(_np(geom.obj_id))) == 4  # obj ids distinguish the groups
    assert geom.positions.device.type == "cpu"


def test_obj_scene_renders(obj_scene):
    geom, mats, atlas = load_obj(str(obj_scene), device="cpu")
    scene = ttt.commit(geom, mats, textures=atlas)
    cam = ttt.Camera.make(position=(0.5, 0.5, 2.0), direction=(0, 0, -1), device="cpu")
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=4, bounces=2,
                             integrator=ttt.Integrator.DIRECT)
    assert torch.isfinite(ttt.render(scene, cam, opts).mean()).all()


def test_image_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (16, 16, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    save_image(p, img)
    back = load_image(p, srgb=False)
    assert np.abs(back - img).max() < 2 / 255


def test_hdr_roundtrip(tmp_path):
    from terra_tpu_torch.io.image import load_hdr, save_hdr

    img = np.asarray([[[0.5, 2.0, 10.0], [0.0, 0.0, 0.0]]], np.float32)
    p = str(tmp_path / "t.hdr")
    save_hdr(p, img)
    np.testing.assert_allclose(load_hdr(p), img, rtol=0.02, atol=1e-6)


def test_config_parse_and_export(tmp_path):
    p = tmp_path / "satellite.config"
    p.write_text(textwrap.dedent("""\
        # comment
        width = 128
        render_samples = 32
        render_integrator = direct-mis
        render_tonemap = uncharted2
        camera_position = 1 2 3
        camera_fov = 60
    """))
    cfg = load_config_file(str(p))
    opts = cfg.render_options()
    assert opts.width == 128 and opts.samples_per_pixel == 32
    assert opts.integrator is ttt.Integrator.DIRECT_MIS
    assert opts.tonemap is ttt.Tonemap.UNCHARTED2
    cam = cfg.camera(device="cpu")
    np.testing.assert_allclose(_np(cam.position), [1, 2, 3])
    out = tmp_path / "saved.config"  # reverse-sync (opt save) then re-load
    cfg.save(str(out))
    assert load_config_file(str(out)).render_options() == opts


def test_config_unknown_key():
    with pytest.raises(KeyError):
        Config().set("not_an_option", "1")


def test_checkpoint_roundtrip(tmp_path):
    film = Film.create(8, 4, "cpu")
    film = Film(acc=film.acc + 3.0, samples=film.samples + 7)
    p = str(tmp_path / "state.npz")
    save_render_state(p, film, seed=42, meta={"note": "x"})
    film2, seed, meta = load_render_state(p, device="cpu")
    assert seed == 42 and meta["note"] == "x"
    assert torch.equal(film2.acc, film.acc) and torch.equal(film2.samples, film.samples)


def test_cli_render_cornell(tmp_path):
    out = str(tmp_path / "out.png")
    rc = cli.main([
        "render", "--cornell", "-o", out, "--width", "16", "--height", "16",
        "--spp", "2", "--bounces", "1", "--integrator", "simple",
        "--opt", "render_accelerator=brute", "--device", "cpu",
    ])
    assert rc == 0 and read_png(out).shape == (16, 16, 3)


def test_obj_native_matches_python(obj_scene):
    """The native numeric parser agrees with the Python twin record for
    record."""
    raw = open(obj_scene, errors="replace").read()
    py = obj_mod._parse_python(raw)
    nat = native.obj_parse(raw)
    for name, a, b in zip(["verts", "norms", "uvs", "face_idx", "face_line"], py, nat):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"native/python mismatch in {name}")


def test_per_scene_config_autoload(obj_scene, tmp_path):
    """Scene.cpp:121-128: loading scenes/foo.obj picks up scenes/foo.config."""
    (tmp_path / "box.config").write_text("render_samples = 3\nrender_bounces = 1\n")
    cfg = Config()
    cfg.set("scene", str(obj_scene))
    assert cli._autoload_scene_config(cfg) is not None
    assert cfg.get("render_samples") == 3 and cfg.get("render_bounces") == 1
    assert cfg.get("scene") == str(obj_scene)  # cannot redirect the scene itself


def test_per_scene_config_absent_is_noop(obj_scene):
    cfg = Config()
    cfg.set("scene", str(obj_scene).replace("box.obj", "missing.obj"))
    assert cli._autoload_scene_config(cfg) is None


@pytest.fixture
def console_home(tmp_path, monkeypatch):
    """The console's readline history goes to a temporary HOME."""
    monkeypatch.setenv("HOME", str(tmp_path))


def test_console_opt_propagation(monkeypatch, console_home):
    """A scene-affecting `opt set` re-commits the scene before the next
    step without an explicit `reload` (App.cpp:663-672 -> Scene.cpp:426-454)."""
    calls = []
    real_build = cli._build_scene

    def counting_build(cfg, args):
        calls.append(tuple(cfg.get("envmap_color")))
        return real_build(cfg, args)

    monkeypatch.setattr(cli, "_build_scene", counting_build)
    lines = iter([
        "opt set width 8", "opt set height 8", "opt set render_samples 1",
        "opt set render_bounces 0", "opt set render_integrator simple",
        "step",
        "opt set render_exposure 2",   # render-range opt: film clears, NO rebuild
        "step",
        "opt set envmap_color 1 1 1",  # scene-affecting opt: rebuild on next step
        "step",
        "exit",
    ])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    rc = cli.cmd_console(argparse.Namespace(scene=None, cornell=True, device="cpu"))
    assert rc == 0
    assert calls == [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0)]


def test_console_loop_pause(monkeypatch, console_home):
    """`loop` with no count runs until `pause` (App.cpp:30-49,
    Renderer.cpp:165-202): the poll between passes stops it there."""
    polls = iter([False, False, True])
    monkeypatch.setattr(cli, "_poll_pause", lambda: next(polls))
    lines = iter([
        "opt set width 8", "opt set height 8", "opt set render_samples 1",
        "opt set render_bounces 0", "opt set render_integrator simple",
        "loop",        # no count: runs until the 3rd poll pauses it
        "pause",       # outside a loop: a no-op with a message
        "exit",
    ])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: out.append(" ".join(map(str, a))))
    rc = cli.cmd_console(argparse.Namespace(scene=None, cornell=True, device="cpu"))
    assert rc == 0
    assert any("paused after 3 passes" in s for s in out), out
    assert any("3 spp accumulated" in s for s in out), out
    assert any("nothing running" in s for s in out), out


def test_cli_preview_every(tmp_path, monkeypatch):
    """--preview-every N rewrites the output during --passes
    (Visualization.cpp:213)."""
    count = [0]
    real = image_mod.save_image

    def counting(path, img):
        count[0] += 1
        real(path, img)

    monkeypatch.setattr(image_mod, "save_image", counting)
    out = str(tmp_path / "o.png")
    rc = cli.main([
        "render", "--cornell", "-o", out, "--width", "8", "--height", "8",
        "--spp", "1", "--bounces", "0", "--integrator", "simple",
        "--passes", "3", "--preview-every", "1",
        "--opt", "render_accelerator=brute", "--device", "cpu",
    ])
    assert rc == 0 and os.path.exists(out)
    assert count[0] == 3  # previews after pass 1 and 2 + the final write


def test_ldr_overflow_warning(tmp_path, caplog):
    """Visualization.cpp:334-341: warn when clamping >1 values into LDR."""
    import logging

    with caplog.at_level(logging.WARNING, logger="terra_tpu_torch"):
        save_image(str(tmp_path / "x.png"), torch.full((4, 4, 3), 2.0))
    assert any("clamping" in r.message for r in caplog.records)


# -- the port against the reference ------------------------------------------

@pytest.mark.parametrize("fixture", ["obj_scene", "textured_obj_scene"])
def test_load_obj_matches_reference(fixture, request):
    path = str(request.getfixturevalue(fixture))
    geom, mats, atlas = load_obj(path, device="cpu")
    jgeom, jmats, jatlas = jload_obj(path)
    _assert_same_arrays(geom, jgeom, GEOMETRY)
    _assert_same_arrays(mats, jmats, MATERIALS)
    _assert_same_arrays(atlas, jatlas, ATLAS)
    assert atlas.num_textures == (1 if fixture == "textured_obj_scene" else 0)


@pytest.mark.parametrize("fixture", ["obj_scene", "textured_obj_scene"])
def test_mtl_classification_matches_reference(fixture, request):
    from terra_tpu.io import obj as jobj_mod

    path = str(request.getfixturevalue(fixture))
    mtl = os.path.join(os.path.dirname(path), "box.mtl")
    mine, ref = obj_mod._parse_mtl(mtl), jobj_mod._parse_mtl(mtl)
    assert sorted(mine) == sorted(ref)
    for name in mine:
        assert int(mine[name].bsdf()) == int(ref[name].bsdf())
        assert mine[name].bsdf().name == ref[name].bsdf().name


def test_png_written_decodes_in_pil(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1.2, (23, 31, 3)).astype(np.float32)
    p = str(tmp_path / "w.png")
    save_image(p, img)
    with Image.open(p) as im:
        assert im.mode == "RGB"
        got = np.asarray(im)
    np.testing.assert_array_equal(got, (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reads_pil_modes(tmp_path, mode):
    """Pillow-written PNGs of each colour type decode to Pillow's own
    ``convert("RGB")`` bytes (its encoder picks row filters adaptively)."""
    rng = np.random.default_rng(2)
    base = (np.add.outer(np.arange(40), 3 * np.arange(50)) % 256).astype(np.uint8)
    rgb = np.stack([base, base[::-1], rng.integers(0, 256, base.shape, dtype=np.uint8)], -1)
    p = str(tmp_path / f"{mode}.png")
    Image.fromarray(rgb).convert(mode).save(p)
    with Image.open(p) as im:
        ref = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_png(p), ref)
    np.testing.assert_array_equal(load_image(p, srgb=False), ref.astype(np.float32) / 255.0)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(u8: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose row y carries filter ``kinds[y % len(kinds)]``,
    encoded by the PNG specification's formulas."""
    h, w, _ = u8.shape
    rows = u8.reshape(h, w * 3).astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(3, np.int32), x[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kind]
        out.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 0, 3, 1, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_row_filters(tmp_path, kinds):
    u8 = np.random.default_rng(3).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    u8[:, :5] = 250  # long runs and wrap-around sums
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_filtered_png(u8, kinds))
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im), u8)
    np.testing.assert_array_equal(read_png(p), u8)


@pytest.mark.parametrize("feature", ["16-bit", "interlaced"])
def test_png_unsupported_raises(tmp_path, feature):
    p = str(tmp_path / "u.png")
    if feature == "16-bit":
        Image.fromarray(np.full((4, 4), 40000, np.uint16)).save(p)
    else:
        with open(p, "wb") as f:
            ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)  # interlace method 1
            f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                    + _chunk(b"IDAT", zlib.compress(bytes(64))) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=feature.split("-")[0]) as err:
        load_image(p)
    assert p in str(err.value)


def test_image_io_without_pillow(tmp_path, monkeypatch):
    """PNG and HDR need no Pillow; the formats that do name .png and .hdr."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(4).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    png, hdr, jpg = (str(tmp_path / f"x.{e}") for e in ("png", "hdr", "jpg"))
    save_image(png, img)
    assert np.abs(load_image(png, srgb=False) - img).max() <= 0.5 / 255 + 1e-7
    save_image(hdr, img)
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    assert (np.abs(load_image(hdr) - img) <= img.max(axis=-1, keepdims=True) / 128).all()
    with pytest.raises(ImportError, match=r"\.png or \.hdr"):
        save_image(jpg, img)
    open(jpg, "wb").close()
    with pytest.raises(ImportError, match=r"\.png or \.hdr"):
        load_image(jpg)


CROSS_CONFIG = """\
width = 96
height = 64
render_samples = 12
render_integrator = debug-mis-weights
render_tonemap = filmic
render_sampler = halton
render_accelerator = brute
render_bvh_builder = lbvh
render_intersector = watertight
render_light_pick = area
render_env_nee = on
camera_position = (1, 2, 3)
camera_fov = 30
envmap_color = 0.25
"""


@pytest.mark.parametrize("writer", ["terra_tpu", "terra_tpu_torch"])
def test_config_files_cross_load(tmp_path, writer):
    """A config saved by either package loads in the other to equal
    options (enums compared by name and value)."""
    src = tmp_path / "in.config"
    src.write_text(CROSS_CONFIG)
    saved = str(tmp_path / "saved.config")
    (jload_config_file if writer == "terra_tpu" else load_config_file)(str(src)).save(saved)
    mine, ref = load_config_file(saved), jload_config_file(saved)
    assert mine.values == load_config_file(str(src)).values
    assert sorted(mine.values) == sorted(ref.values)
    for k, v in mine.values.items():
        r = ref.values[k]
        if hasattr(v, "name"):
            assert type(v).__module__ == "terra_tpu_torch.scene", k
            assert (v.name, int(v)) == (r.name, int(r)), k
        else:
            assert v == r, k
    assert mine.explicit == ref.explicit


def test_describe_matches_reference():
    """``opt-list`` prints the reference's lines; only the three compat
    options drop "on TPU" from their descriptions."""
    mine, ref = Config().describe(), JConfig().describe()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a == b.replace(" — unused on TPU", " — unused")


def test_opt_list(capsys):
    assert cli.main(["opt-list"]) == 0
    assert capsys.readouterr().out.splitlines() == Config().describe()


def test_cli_without_cuda_names_device_cpu(monkeypatch, tmp_path):
    """No device is picked by availability: asking for CUDA where there is
    none exits and names --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["render", "--cornell", "-o", str(tmp_path / "x.png")], ["console"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(argv)


def test_cli_film_matches_reference(tmp_path):
    """Both command lines render the OBJ fixture (8x8, 2 spp, the default
    DIRECT_MIS with 4 bounces and lanes of 8) under a constant sky: the
    checkpoint films agree under the golden twin budgets."""
    d = tmp_path / "s"
    d.mkdir()
    (d / "box.mtl").write_text(BOX_MTL)
    (d / "box.obj").write_text(BOX_OBJ)
    args = ["render", str(d / "box.obj"), "--width", "8", "--height", "8", "--spp", "2",
            "--opt", "camera_position=0.5,0.5,-2", "--opt", "camera_direction=0,0,1",
            "--opt", "render_jitter=0.5", "--opt", "envmap_color=1,1,1",
            "--opt", "render_env_on_miss=true"]
    assert jcli.main(args + ["--checkpoint", str(tmp_path / "j.npz")]) == 0
    assert cli.main(args + ["--checkpoint", str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        np.testing.assert_array_equal(t["samples"], j["samples"])
        img = t["acc"] / np.maximum(t["samples"], 1)[..., None]
        ref = j["acc"] / np.maximum(j["samples"], 1)[..., None]
    assert ref.mean() > 0.1
    _assert_twin_match(img, ref, 2e-3, 8e-3, 5e-3)


def test_console_script_step_then_save(tmp_path):
    """A console script on stdin: `step` polls stdin only between passes,
    so the `save` after it runs (the reference's `step` reads and ignores
    the rest of a piped script, ROADMAP C6)."""
    script = "\n".join(["opt set width 8", "opt set height 8", "opt set render_samples 1",
                        "opt set render_bounces 0", "opt set render_integrator simple",
                        "step", f"save {tmp_path / 'x.png'}", "mesh list", "exit"]) + "\n"
    env = dict(os.environ, PYTHONPATH=ROOT, HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "terra_tpu_torch", "console", "--cornell",
                           "--device", "cpu"], input=script, capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ignored" not in proc.stdout and "1 spp accumulated" in proc.stdout
    assert read_png(str(tmp_path / "x.png")).shape == (8, 8, 3)
    assert "object    7: 10 tris" in proc.stdout  # the tall block


# -- a scene written as OBJ + MTL + PNG loads back to its arrays ---------------

def export_obj(scene, directory, name):
    """Write a committed scene (DIFFUSE and GGX materials) as
    ``name.obj`` + ``name.mtl`` + one PNG per texture, so that
    ``load_obj`` gives back its arrays: z negated and faces wound (v0, v2,
    v1), undone by the loader's handedness flip; floats as %.9g, which
    round-trips float32; materials named so their sorted order is their
    id; texels stored as round(255 v^(1/2.2)), which ``srgb_decode``
    inverts to within 8-bit steps."""
    g, m, tex = scene.geometry, scene.materials, scene.textures
    pos, vidx = _np(g.positions), _np(g.tri_vidx).astype(np.int64)
    nrm, uvs, mid = _np(g.normals), _np(g.uvs), _np(g.mat_id)
    flip = np.asarray([1, 1, -1], np.float32)
    t = len(vidx)

    def rows(fmt, arr):
        return "\n".join(map(fmt.__mod__, map(tuple, arr.tolist())))

    corner = np.arange(3 * t, dtype=np.int64).reshape(t, 3) + 1
    face = np.stack([vidx + 1, corner, corner], axis=-1)[:, (0, 2, 1)].reshape(t, 9)
    starts = np.flatnonzero(np.diff(mid)) + 1
    faces = []
    for s, e in zip(np.concatenate([[0], starts]), np.concatenate([starts, [t]])):
        faces.append(f"usemtl m{int(mid[s]):03d}")
        faces.append(rows("f %d/%d/%d %d/%d/%d %d/%d/%d", face[s:e]))
    with open(os.path.join(directory, f"{name}.obj"), "w") as f:
        f.write("\n".join([f"mtllib {name}.mtl", rows("v %.9g %.9g %.9g", pos * flip),
                           rows("vn %.9g %.9g %.9g", nrm.reshape(-1, 3) * flip),
                           rows("vt %.9g %.9g", uvs.reshape(-1, 2)), *faces]) + "\n")

    bsdf, attrs, attr_tex, emis = (_np(x) for x in (m.bsdf_type, m.attrs, m.attr_tex, m.emissive))
    lines = []
    for i in range(len(bsdf)):
        lines += [f"newmtl m{i:03d}", "Kd %.9g %.9g %.9g" % tuple(attrs[i, 0].tolist()),
                  "Ke %.9g %.9g %.9g" % tuple(emis[i].tolist())]
        if bsdf[i] == int(ttt.BSDFType.GGX):
            lines += ["Pr %.9g" % attrs[i, 1, 0], "Pm %.9g" % attrs[i, 2, 0]]
        elif bsdf[i] != int(ttt.BSDFType.DIFFUSE):
            raise ValueError(f"material {i}: only DIFFUSE and GGX are exported")
        if attr_tex[i, 0] >= 0:
            lines.append(f"map_Kd tex{int(attr_tex[i, 0])}.png")
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    data, size = _np(tex.data), _np(tex.size)
    for k in range(len(data)):
        h, w = size[k]
        u8 = np.round(255.0 * np.power(np.clip(data[k, :h, :w], 0, 1), 1 / 2.2))
        image_mod.write_png(os.path.join(directory, f"tex{k}.png"), u8.astype(np.uint8))
    return os.path.join(directory, f"{name}.obj")


def test_courtyard_export_roundtrip(tmp_path):
    """A small courtyard (12 x 12 terrain, 4 columns) through OBJ + MTL +
    PNG: every array bit-equal but the obj ids (the file groups faces by
    material) and the texels (8-bit sRGB steps)."""
    scene = ttt.scenes.courtyard(grid=12, columns=4, column_segments=8, column_levels=4,
                                 accelerator=ttt.Accelerator.BRUTE, device="cpu")
    geom, mats, atlas = load_obj(export_obj(scene, str(tmp_path), "yard"), device="cpu")
    _assert_same_arrays(geom, scene.geometry, GEOMETRY[:-1])
    _assert_same_arrays(mats, scene.materials, MATERIALS)
    _assert_same_arrays(atlas, scene.textures, ATLAS[1:])
    enc = np.power(np.clip(_np(scene.textures.data), 0, 1), 1 / 2.2) * 255.0
    back = np.power(_np(atlas.data), 1 / 2.2) * 255.0
    assert atlas.data.shape == scene.textures.data.shape
    assert np.abs(back - enc).max() <= 0.5 + 1e-3
