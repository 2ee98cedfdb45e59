"""Utility runner: `python -m mitsuba_tpu_torch.mtsutil <tool> ...` (port of
mtsutil.py).

The analog of the reference's `mtsutil` plugin runner
(src/mitsuba/mtsutil.cpp) with the utilities from src/utils/:
  kdbench    rays/second of trace.closest_hit (kdbench.cpp:35-66), on the
             CUDA device unless --cpu: the brute-force kernel, or the BVH
             kernel on a scene above 4,096 triangles
  tonemap    HDR -> LDR conversion (tonemap.cpp)
  addimages  weighted sum of two images (addimages.cpp)
  joinrgb    merge three single-channel images into RGB (joinrgb.cpp)
  rendertime the renderTime of EXR headers (data/scripts/rendertime.py)
  mtsimport  COLLADA .dae -> scene XML + .serialized (mtsimport.cpp)
The image and import tools run on the host (numpy), over io/image.py,
io/collada.py and io/serialized.py.
"""
from __future__ import annotations

import argparse
import sys
import time

KDBENCH_REPS = 10


def kdbench_rays(scene, n, seed=0):
    """The JAX tool's rays over the scene's bounding sphere: origins
    uniform on the sphere, each direction a second uniform unit vector
    with its component along the origin's radius removed (tangent to the
    sphere; toward the centre where the two nearly coincide), drawn from
    a torch.Generator on the scene's device. Returns (o, d)."""
    import torch

    dev = scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lo = torch.amin(scene.vertices, 0)
    hi = torch.amax(scene.vertices, 0)
    center = (lo + hi) / 2
    radius = float(torch.linalg.vector_norm(hi - lo)) / 2
    a = torch.randn((n, 3), generator=gen, device=dev)
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = torch.randn((n, 3), generator=gen, device=dev)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    ab = torch.sum(a * b, -1, keepdim=True)
    d = torch.where(torch.abs(ab) > 0.999, -a, b - a * ab)
    return center + a * radius, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def tool_kdbench(argv):
    """Prints and returns {"triangles", "rays", "rays_per_s", "ms_per_batch",
    "hit_share"}: the last batch's share of rays that hit."""
    ap = argparse.ArgumentParser(prog="mtsutil kdbench")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene XML (default: built-in Cornell box)")
    ap.add_argument("-n", "--rays", type=int, default=1 << 20)
    ap.add_argument("--cpu", action="store_true",
                    help="trace on the CPU (the default is the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    from .ops import trace
    from .scene import builtin, bvh as bvhlib, xml as xmllib

    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        raise SystemExit("no CUDA device: pass --cpu to trace on the CPU")
    if args.scene:
        scene, _, _, _ = xmllib.load_xml(args.scene, device=dev)
        if scene.num_triangles > trace.BRUTE_MAX_TRIS:
            scene = bvhlib.attach(scene)
    else:
        scene, _ = builtin.cornell_box(device=dev)
    o, d = kdbench_rays(scene, args.rays)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    trace.closest_hit(scene, o, d)
    sync()
    t0 = time.perf_counter()
    for _ in range(KDBENCH_REPS):
        its = trace.closest_hit(scene, o, d)
    sync()
    dt = (time.perf_counter() - t0) / KDBENCH_REPS
    print(f"{scene.num_triangles} triangles, {args.rays} rays: "
          f"{args.rays / dt / 1e6:.2f} M rays/s ({dt * 1e3:.2f} ms/batch)")
    return {"triangles": scene.num_triangles, "rays": args.rays,
            "rays_per_s": args.rays / dt, "ms_per_batch": dt * 1e3,
            "hit_share": float(its.valid.float().mean())}


def tool_tonemap(argv):
    ap = argparse.ArgumentParser(prog="mtsutil tonemap")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-m", "--multiplier", type=float, default=1.0)
    ap.add_argument("-g", "--gamma", type=float, default=-1.0,
                    help="-1 = sRGB curve (default)")
    args = ap.parse_args(argv)
    import numpy as np

    from .io import image

    img = image.read_auto(args.input) * args.multiplier
    out = args.output or (args.input.rsplit(".", 1)[0] + ".png")
    if args.gamma > 0:
        image.write_png(out, np.clip(img, 0, 1) ** (1.0 / args.gamma), tonemap=False)
    else:
        image.write_png(out, img, tonemap=True)
    print(f"wrote {out}")


def tool_addimages(argv):
    ap = argparse.ArgumentParser(prog="mtsutil addimages")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("output")
    ap.add_argument("--wa", type=float, default=1.0)
    ap.add_argument("--wb", type=float, default=1.0)
    args = ap.parse_args(argv)
    from .io import image

    image.write_image(args.output,
                      image.read_auto(args.a) * args.wa + image.read_auto(args.b) * args.wb)
    print(f"wrote {args.output}")


def tool_joinrgb(argv):
    ap = argparse.ArgumentParser(prog="mtsutil joinrgb")
    ap.add_argument("r")
    ap.add_argument("g")
    ap.add_argument("b")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    import numpy as np

    from .io import image

    chans = [image.read_auto(p) for p in (args.r, args.g, args.b)]
    chans = [c[..., 0] if c.ndim == 3 else c for c in chans]
    image.write_image(args.output, np.stack(chans, -1))
    print(f"wrote {args.output}")


def tool_mtsimport(argv):
    """COLLADA -> scene conversion (src/converter/mtsimport.cpp analog):
    parse the .dae, write the meshes as one .serialized file and a scene
    XML referencing them with a default sensor and a constant light."""
    ap = argparse.ArgumentParser(prog="mtsutil mtsimport")
    ap.add_argument("dae", help="input COLLADA .dae file")
    ap.add_argument("out", help="output scene .xml path")
    ap.add_argument("--fov", type=float, default=45.0)
    args = ap.parse_args(argv)
    from pathlib import Path

    from .io import collada, serialized as serlib

    meshes = collada.load_dae(args.dae)
    if not meshes:
        raise SystemExit(f"no triangle geometry found in {args.dae}")
    out = Path(args.out)
    ser = out.with_suffix(".serialized")
    serlib.write_serialized(ser, meshes)

    shapes = "\n".join(
        f'    <shape type="serialized">\n'
        f'        <string name="filename" value="{ser.name}"/>\n'
        f'        <integer name="shapeIndex" value="{i}"/>\n'
        f'        <bsdf type="diffuse"/>\n'
        f'    </shape>' for i in range(len(meshes)))
    out.write_text(f"""<scene version="0.6.0">
    <integrator type="path"/>
    <sensor type="perspective">
        <float name="fov" value="{args.fov}"/>
        <film type="hdrfilm">
            <integer name="width" value="256"/>
            <integer name="height" value="256"/>
        </film>
    </sensor>
    <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
{shapes}
</scene>
""")
    total = sum(len(m.indices) for m in meshes)
    print(f"imported {len(meshes)} mesh(es), {total} triangles -> {out} + {ser.name}")


def tool_rendertime(argv):
    """Print the render-time metadata of EXR headers
    (data/scripts/rendertime.py:14 analog)."""
    ap = argparse.ArgumentParser(prog="mtsutil rendertime")
    ap.add_argument("images", nargs="+", help="EXR file(s)")
    args = ap.parse_args(argv)
    from .io import image as imagelib

    total = 0.0
    for p in args.images:
        attrs = imagelib.read_exr_attrs(p)
        t = attrs.get("renderTime")
        if t is None:
            print(f"{p}: no renderTime attribute")
        else:
            print(f"{p}: {float(t):.2f} s"
                  + (f" ({attrs['spp']:.0f} spp)" if "spp" in attrs else ""))
            total += float(t)
    if len(args.images) > 1:
        print(f"total: {total:.2f} s")


TOOLS = {
    "kdbench": tool_kdbench,
    "rendertime": tool_rendertime,
    "tonemap": tool_tonemap,
    "addimages": tool_addimages,
    "joinrgb": tool_joinrgb,
    "mtsimport": tool_mtsimport,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m mitsuba_tpu_torch.mtsutil <tool> ...\n"
              f"tools: {', '.join(sorted(TOOLS))}", file=sys.stderr)
        return 1
    TOOLS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
