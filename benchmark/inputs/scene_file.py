"""A configuration's scene as a user's Mitsuba 0.6 scene file: one OBJ per
run of triangles that share a material and an emission, a `diffuse` bsdf
per material, an `area` emitter on each emitting OBJ, and the sensor,
sampler, film and integrator the configuration names.

A frozen copy of `chip_smoke.py`'s `obj_groups` / `write_scene_files` (and
of `mitsuba_tpu_torch/io/mesh.py:save_obj`'s OBJ lines), in numpy only, so
that a later change to the program cannot move the benchmark's inputs.
The one difference: emitting triangles of one radiance share an OBJ.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np


def _csv(v):
    return ", ".join(repr(float(x)) for x in np.asarray(v, np.float32).ravel())


def obj_groups(vertices, indices, tri_material, tri_radiance):
    """Runs of consecutive triangles sharing a material and a radiance, each
    as (material, radiance or None, its vertices in first-use order, its
    indices into them)."""
    rad = np.zeros((len(indices), 3), np.float32)
    for t, r in tri_radiance.items():
        rad[t] = r
    key = np.concatenate([tri_material[:, None].astype(np.float32), rad], 1)
    cuts = np.flatnonzero((key[1:] != key[:-1]).any(1)) + 1
    groups = []
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(indices)]):
        tris = indices[lo:hi]
        first = np.unique(tris.ravel(), return_index=True)[1]
        used = tris.ravel()[np.sort(first)]
        remap = np.full(vertices.shape[0], -1, np.int64)
        remap[used] = np.arange(len(used))
        emits = lo in tri_radiance
        groups.append((int(tri_material[lo]), rad[lo] if emits else None,
                       vertices[used], remap[tris].astype(np.int32)))
    return groups


def save_obj(path, vertices, indices):
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in np.asarray(vertices)]
    lines += [f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}" for t in np.asarray(indices)]
    Path(path).write_text("\n".join(lines) + "\n")


def reflectances(config: dict) -> list:
    """The configuration's bsdf reflectances, in the scene file's order."""
    geo = importlib.import_module(f"benchmark.inputs.{config['geometry']}")
    return geo.geometry(**config.get("geometry_args", {}))[3]


def write(directory, config: dict, refl=None, radiance_factor=None) -> Path:
    """Write the configuration's scene into `directory`; returns the XML's
    path. `config["geometry"]` names a module of this folder whose
    `geometry(**config["geometry_args"])` gives the arrays and whose `VIEW`
    gives the camera. `refl` replaces the bsdfs' reflectances;
    `radiance_factor` (3,) scales every emitter's radiance."""
    geo = importlib.import_module(f"benchmark.inputs.{config['geometry']}")
    verts, tris, tri_mat, own, tri_rad = geo.geometry(**config.get("geometry_args", {}))
    refl = own if refl is None else refl
    if radiance_factor is not None:
        tri_rad = {t: tuple(np.float32(np.asarray(r) * radiance_factor)) for t, r in tri_rad.items()}
    view = geo.VIEW
    film, integ = config["film"], config["integrator"]
    sensor = (f'<sensor type="{config["sensor"]}"><float name="fov" value="{view["fov_x"]}"/>'
              f'<transform name="toWorld"><lookat origin="{_csv(view["origin"])}" '
              f'target="{_csv(view["target"])}" up="{_csv(view["up"])}"/></transform>'
              f'<sampler type="{config["sampler"]}"><integer name="sampleCount" '
              f'value="{config["spp"]}"/></sampler><film type="hdrfilm"><integer name="width" '
              f'value="{film["width"]}"/><integer name="height" value="{film["height"]}"/>'
              f'<rfilter type="{film["rfilter"]}"/></film></sensor>')
    integrator = (f'<integrator type="{integ["type"]}"><integer name="maxDepth" '
                  f'value="{integ["maxDepth"]}"/><integer name="rrDepth" '
                  f'value="{integ["rrDepth"]}"/></integrator>')
    parts = ['<scene version="0.6.0">', integrator, sensor]
    parts += [f'<bsdf type="diffuse" id="m{i}"><rgb name="reflectance" value="{_csv(r)}"/>'
              f'</bsdf>' for i, r in enumerate(refl)]
    directory = Path(directory)
    for g, (mat, rad, gv, gt) in enumerate(obj_groups(verts, tris, tri_mat, tri_rad)):
        save_obj(directory / f"g{g:02d}.obj", gv, gt)
        emitter = ("" if rad is None else
                   f'<emitter type="area"><rgb name="radiance" value="{_csv(rad)}"/></emitter>')
        parts.append(f'<shape type="obj"><string name="filename" value="g{g:02d}.obj"/>'
                     f'<ref id="m{mat}"/>{emitter}</shape>')
    xml_path = directory / "scene.xml"
    xml_path.write_text("\n".join(parts + ["</scene>"]) + "\n")
    return xml_path
