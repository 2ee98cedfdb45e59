"""COLLADA (.dae) geometry importer (a copy of the JAX package's
io/collada.py, numpy only).

The analog of the reference converter (src/converter/collada.cpp
+ mtsimport.cpp): where the reference links Assimp/OpenCOLLADA and walks
the full DOM, this parses the XML directly (stdlib ElementTree) for the
geometry subset that matters to rendering — <library_geometries> meshes
(<triangles>/<polylist>/<polygons> with VERTEX/NORMAL/TEXCOORD inputs),
the <library_visual_scenes> node graph with matrix/translate/rotate/
scale transforms and instance_geometry bindings, and the asset up-axis
convention (Z_UP/X_UP content is rotated into the renderer's Y_UP frame,
matching collada.cpp's conditioning step).

Per-corner COLLADA indices are uniquified into (v, n, uv) triples —
the same vertex-cache de-indexing obj.cpp does — so the output MeshData
plugs straight into scene/ir.build_scene.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from .mesh import MeshData

# content up-axis -> renderer frame (collada.cpp handles Y_UP/Z_UP;
# X_UP appears in the spec so it is covered too)
_UP_FIX = {
    "Y_UP": np.eye(3, dtype=np.float32),
    "Z_UP": np.asarray([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32),
    "X_UP": np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32),
}


def _strip(tag: str) -> str:
    """Drop the xmlns prefix ElementTree keeps on every tag."""
    return tag.rsplit("}", 1)[-1]


def _find_all(node, name):
    return [c for c in node.iter() if _strip(c.tag) == name]


def _children(node, name):
    return [c for c in node if _strip(c.tag) == name]


def _floats(text: str) -> np.ndarray:
    return np.asarray([float(x) for x in text.split()], np.float32)


def _parse_sources(mesh_node):
    """id -> (array (N, stride), stride) for every <source>."""
    out = {}
    for src in _children(mesh_node, "source"):
        sid = src.attrib.get("id", "")
        arrs = _children(src, "float_array")
        if not arrs:
            continue
        data = _floats(arrs[0].text or "")
        stride = 3
        for tech in _children(src, "technique_common"):
            for acc in _children(tech, "accessor"):
                stride = int(acc.attrib.get("stride", 3))
        out[sid] = data.reshape(-1, stride)
    return out


def _node_transform(node) -> np.ndarray:
    """Compose this <node>'s transform elements in document order
    (COLLADA applies them right-to-left, i.e. sequentially post-
    multiplied — collada.cpp's conditioner does the same)."""
    t = np.eye(4, dtype=np.float32)
    for c in node:
        tag = _strip(c.tag)
        if tag == "matrix":
            t = t @ _floats(c.text or "").reshape(4, 4)
        elif tag == "translate":
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = _floats(c.text or "")[:3]
            t = t @ m
        elif tag == "rotate":
            x, y, z, deg = _floats(c.text or "")[:4]
            axis = np.asarray([x, y, z], np.float32)
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                a = np.deg2rad(deg)
                cth, sth = np.cos(a), np.sin(a)
                k = np.asarray([[0, -axis[2], axis[1]],
                                [axis[2], 0, -axis[0]],
                                [-axis[1], axis[0], 0]], np.float32)
                r = np.eye(3) + sth * k + (1 - cth) * (k @ k)
                m = np.eye(4, dtype=np.float32)
                m[:3, :3] = r
                t = t @ m
        elif tag == "scale":
            m = np.eye(4, dtype=np.float32)
            np.fill_diagonal(m[:3, :3], _floats(c.text or "")[:3])
            t = t @ m
    return t


def _parse_geometry(geo_node):
    """<geometry> -> MeshData in local coordinates (None if not a mesh)."""
    meshes = _children(geo_node, "mesh")
    if not meshes:
        return None
    mesh = meshes[0]
    sources = _parse_sources(mesh)
    # <vertices> indirection: its POSITION input names the actual source
    vert_src = {}
    for verts in _children(mesh, "vertices"):
        vid = verts.attrib.get("id", "")
        for inp in _children(verts, "input"):
            if inp.attrib.get("semantic") == "POSITION":
                vert_src[vid] = inp.attrib["source"].lstrip("#")

    tris_v, tris_n, tris_uv = [], [], []
    pos_arr = nrm_arr = uv_arr = None
    for prim in mesh:
        ptag = _strip(prim.tag)
        if ptag not in ("triangles", "polylist", "polygons"):
            continue
        inputs = {}           # semantic -> (offset, source array)
        max_off = 0
        for inp in _children(prim, "input"):
            sem = inp.attrib["semantic"]
            off = int(inp.attrib.get("offset", 0))
            src = inp.attrib["source"].lstrip("#")
            if sem == "VERTEX":
                src = vert_src.get(src, src)
            inputs[sem] = (off, sources.get(src))
            max_off = max(max_off, off)
        stride = max_off + 1

        p_nodes = _children(prim, "p")
        if ptag == "polygons":
            # one <p> per polygon
            polys = [np.asarray([int(x) for x in (p.text or "").split()],
                                np.int64).reshape(-1, stride)
                     for p in p_nodes]
        else:
            idx = np.asarray([int(x) for x in (p_nodes[0].text or "").split()],
                             np.int64).reshape(-1, stride)
            if ptag == "polylist":
                counts = [int(x) for x in
                          (_children(prim, "vcount")[0].text or "").split()]
                polys, at = [], 0
                for c in counts:
                    polys.append(idx[at:at + c])
                    at += c
            else:
                polys = [idx[i:i + 3] for i in range(0, len(idx), 3)]

        v_off, pos_arr = inputs.get("VERTEX", (0, None))
        n_off, nrm_arr = inputs.get("NORMAL", (0, None))
        t_off, uv_arr = inputs.get("TEXCOORD", (0, None))
        for poly in polys:
            # fan triangulation, like obj.cpp / the reference conditioner
            for k in range(1, len(poly) - 1):
                for corner in (poly[0], poly[k], poly[k + 1]):
                    tris_v.append(corner[v_off])
                    tris_n.append(corner[n_off] if nrm_arr is not None else -1)
                    tris_uv.append(corner[t_off] if uv_arr is not None else -1)

    if pos_arr is None or not tris_v:
        return None
    # de-index (v, n, uv) corner triples into unique vertices
    triples = np.stack([np.asarray(tris_v), np.asarray(tris_n),
                        np.asarray(tris_uv)], axis=1)
    uniq, inv = np.unique(triples, axis=0, return_inverse=True)
    verts = pos_arr[uniq[:, 0], :3]
    normals = (nrm_arr[np.maximum(uniq[:, 1], 0), :3]
               if nrm_arr is not None else None)
    uvs = uv_arr[np.maximum(uniq[:, 2], 0), :2] if uv_arr is not None else None
    indices = inv.reshape(-1, 3).astype(np.int32)
    md = MeshData(verts, indices, normals=normals, uvs=uvs)
    md.name = geo_node.attrib.get("name", geo_node.attrib.get("id", ""))
    return md


def load_dae(path):
    """Parse a .dae file -> list of world-space MeshData (one per
    instance_geometry in the visual scene; geometries never instanced
    fall back to identity placement so nothing silently disappears)."""
    root = ET.parse(str(path)).getroot()

    up = "Y_UP"
    for ua in _find_all(root, "up_axis"):
        up = (ua.text or "Y_UP").strip()
    fix3 = _UP_FIX.get(up, _UP_FIX["Y_UP"])
    fix = np.eye(4, dtype=np.float32)
    fix[:3, :3] = fix3

    geoms = {}
    for lib in _find_all(root, "library_geometries"):
        for geo in _children(lib, "geometry"):
            md = _parse_geometry(geo)
            if md is not None:
                geoms[geo.attrib.get("id", "")] = md

    out, instanced = [], set()

    def walk(node, parent_t):
        t = parent_t @ _node_transform(node)
        for c in node:
            tag = _strip(c.tag)
            if tag == "instance_geometry":
                gid = c.attrib.get("url", "").lstrip("#")
                if gid in geoms:
                    out.append(_placed(geoms[gid], fix @ t))
                    instanced.add(gid)
            elif tag == "node":
                walk(c, t)

    for lib in _find_all(root, "library_visual_scenes"):
        for vs in _children(lib, "visual_scene"):
            for node in _children(vs, "node"):
                walk(node, np.eye(4, dtype=np.float32))

    for gid, md in geoms.items():
        if gid not in instanced:
            out.append(_placed(md, fix))
    return out


def _placed(md: MeshData, t: np.ndarray) -> MeshData:
    v = md.vertices @ t[:3, :3].T + t[:3, 3]
    n = None
    if md.normals is not None:
        # normals transform by the inverse-transpose
        it = np.linalg.inv(t[:3, :3]).T
        n = md.normals @ it.T
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(ln, 1e-12)
    out = MeshData(v, md.indices, normals=n, uvs=md.uvs)
    out.name = getattr(md, "name", "")
    return out
