"""The plain reference's reading of a scene file: the subset of Mitsuba 0.6's
XML that the benchmark's configurations use, parsed with the standard
library and numpy alone (it imports nothing of the renderer under test).

Semantics, as the renderer under test documents them:
- `perspective` sensor: `fov` across the axis `fovAxis` (x by default),
  `lookat` as `Transform::lookAt` builds it (columns: cross(up, dir), the
  new up, dir, origin); film x to the right along the first column, film y
  down along the second.
- `hdrfilm` with an `rfilter` (Mitsuba's default: gaussian, stddev 0.5,
  radius 2); `box` averages a pixel's own samples.
- `path` with `maxDepth` (edges of a path; -1 means 16) and `rrDepth`.
- `diffuse` bsdfs with an `rgb` reflectance (linear); `area` emitters
  with an `rgb` radiance, one-sided (the front is the side of the
  triangle's counter-clockwise normal).
- `obj` shapes of `v` and `f` lines; without `vn` lines the shading normals
  are area-weighted vertex normals (each vertex sums the unnormalised
  cross products of its faces), interpolated across each triangle.
"""
from __future__ import annotations

import dataclasses
import math
import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Scene:
    vertices: np.ndarray      # (V, 3) float32
    indices: np.ndarray       # (T, 3) int64
    normals: np.ndarray       # (V, 3) float32, area-weighted
    radiance: np.ndarray      # (T, 3) float32, per triangle (0: not an emitter)
    materials: np.ndarray     # (M, 3) float32: each bsdf's reflectance, in file order
    tri_material: np.ndarray  # (T,) int64 row of `materials`
    radiances: np.ndarray     # (E, 3) float32: each emitting shape's radiance, in file order
    tri_emitter: np.ndarray   # (T,) int64 row of `radiances`, -1 where none
    to_world: np.ndarray      # (3, 4) float64: right, up, dir, origin columns
    fov_x: float              # degrees
    width: int
    height: int
    spp: int
    rfilter: str              # "gaussian" or "box"
    max_depth: int
    rr_depth: int


def look_at(origin, target, up):
    d = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    d /= np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    return np.stack([right, new_up, d, np.asarray(origin, np.float64)], 1)


def _vec(s):
    v = [float(x) for x in s.replace(",", " ").split()]
    return v * 3 if len(v) == 1 else v


def read_obj(path):
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(1, len(idx) - 1):        # a polygon as a fan
                faces.append([idx[0], idx[k], idx[k + 1]])
        elif parts[0] == "vn":
            raise ValueError(f"{path}: the reference reads no vn lines")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def load(path) -> Scene:
    path = Path(path)
    root = ET.parse(path).getroot()
    defaults = {d.attrib["name"]: d.attrib["value"] for d in root.findall("default")}

    def sub(s):
        return re.sub(r"\$(\w+)", lambda m: defaults[m.group(1)], s)

    def props(node):
        out = {}
        for c in node:
            if c.tag in ("integer", "float", "string", "boolean", "rgb"):
                out[c.attrib["name"]] = sub(c.attrib["value"])
        return out

    integ = root.find("integrator")
    if integ is None or integ.attrib["type"] != "path":
        raise ValueError("the reference renders the path integrator only")
    ip = props(integ)
    md = int(ip.get("maxDepth", -1))
    sensor = root.find("sensor")
    if sensor.attrib["type"] != "perspective":
        raise ValueError("the reference renders a perspective sensor only")
    sp = props(sensor)
    look = sensor.find("transform/lookat")
    to_world = look_at(_vec(sub(look.attrib["origin"])), _vec(sub(look.attrib["target"])),
                       _vec(sub(look.attrib.get("up", "0, 1, 0"))))
    film = sensor.find("film")
    fp = props(film)
    width, height = int(fp.get("width", 768)), int(fp.get("height", 576))
    rf = film.find("rfilter")
    rfilter = "gaussian" if rf is None else rf.attrib["type"]
    if rfilter not in ("gaussian", "box"):
        raise ValueError(f"the reference has no '{rfilter}' rfilter")
    fov = float(sp["fov"])
    if sp.get("fovAxis", "x") == "y":
        fov = math.degrees(2 * math.atan(math.tan(math.radians(fov / 2)) * width / height))
    elif sp.get("fovAxis", "x") != "x":
        raise ValueError("the reference reads fovAxis x or y")
    spp = int(props(sensor.find("sampler")).get("sampleCount", 4))

    bsdfs, mats = {}, []
    for b in root.findall("bsdf"):
        if b.attrib["type"] != "diffuse":
            raise ValueError("the reference has diffuse bsdfs only")
        bsdfs[b.attrib["id"]] = len(mats)
        mats.append(_vec(props(b).get("reflectance", "0.5")))
    verts, idx, tri_mat, tri_em, les = [], [], [], [], []
    n_v = 0
    for shape in root.findall("shape"):
        if shape.attrib["type"] != "obj":
            raise ValueError("the reference reads obj shapes only")
        v, f = read_obj(path.parent / props(shape)["filename"])
        ref = shape.find("ref")
        if ref is None:
            mats.append([0.5, 0.5, 0.5])
            m = len(mats) - 1
        else:
            m = bsdfs[ref.attrib["id"]]
        em = shape.find("emitter")
        e = -1
        if em is not None:
            if em.attrib["type"] != "area":
                raise ValueError("the reference has area emitters only")
            les.append(_vec(props(em)["radiance"]))
            e = len(les) - 1
        verts.append(v)
        idx.append(f + n_v)
        n_v += len(v)
        tri_mat.append(np.full(len(f), m, np.int64))
        tri_em.append(np.full(len(f), e, np.int64))
    vertices = np.concatenate(verts)
    indices = np.concatenate(idx)
    materials = np.asarray(mats, np.float32).reshape(-1, 3)
    radiances = np.asarray(les, np.float32).reshape(-1, 3)
    tri_material, tri_emitter = np.concatenate(tri_mat), np.concatenate(tri_em)
    radiance = np.where((tri_emitter >= 0)[:, None],
                        radiances[tri_emitter.clip(0)] if len(radiances) else 0.0,
                        0.0).astype(np.float32)
    p0 = vertices[indices[:, 0]].astype(np.float64)
    fn = np.cross(vertices[indices[:, 1]] - p0, vertices[indices[:, 2]] - p0)
    normals = np.zeros(vertices.shape, np.float64)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)
    return Scene(vertices=vertices, indices=indices, normals=normals.astype(np.float32),
                 radiance=radiance, materials=materials,
                 tri_material=tri_material, radiances=radiances, tri_emitter=tri_emitter,
                 to_world=to_world, fov_x=fov, width=width, height=height, spp=spp,
                 rfilter=rfilter, max_depth=16 if md < 0 else md,
                 rr_depth=int(ip.get("rrDepth", 5)))
