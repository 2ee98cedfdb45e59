"""Mitsuba XML scene loader -> flattened Scene IR + Camera + RenderConfig
(port of scene/xml.py).

Compatibility layer replacing the reference's Xerces SceneHandler
(src/librender/scenehandler.cpp:197,273,712 — tag -> Properties ->
PluginManager::createObject) so reference scenes drive the renderer
directly. The parsing and the host-side geometry are the JAX package's
numpy code; the scene, camera and media are built with the port's own
modules on `device`. Unknown plugins raise with the plugin name, the
analog of PluginManager's load failure. The sun, sky and sunsky emitters
are baked into a lat-long envmap (models/sunsky.py, models/hosek.py), with
the Hosek sky's band stack for the spectral renderer; an Irawan BSDF's
weave pattern becomes a slot of the scene's cloth tables
(models/cloth.py).

Also implements `$key` parameter substitution (mitsuba.cpp:58 -D flags) in
every attribute, and <default> declarations. A property no converter read
fails the load (the scene.xsd analog); the list of properties lives on the
load's own `_Loader`, so concurrent loads (the CLI's -j) cannot see each
other's.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from ..integrators import common as integ_common
from ..models import sensor as sensorlib
from . import ir, shapes as shapelib


# ---------------------------------------------------------------------------
# Transforms (scenehandler.cpp transform tags)
# ---------------------------------------------------------------------------

def _mat_translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def _mat_scale(x, y, z):
    return np.diag([x, y, z, 1.0]).astype(np.float32)


def _mat_rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.asarray([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    return m


def _parse_transform(node, subst):
    m = np.eye(4, dtype=np.float32)
    for child in node:
        tag = child.tag
        if tag == "translate":
            t = _mat_translate(*(_fattr(child, k, 0.0, subst) for k in "xyz"))
        elif tag == "scale":
            if "value" in child.attrib:
                v = _f(child.attrib["value"], subst)
                t = _mat_scale(v, v, v)
            else:
                t = _mat_scale(*(_fattr(child, k, 1.0, subst) for k in "xyz"))
        elif tag == "rotate":
            axis = [_fattr(child, k, 0.0, subst) for k in "xyz"]
            t = _mat_rotate(axis, _f(child.attrib.get("angle", "0"), subst))
        elif tag in ("lookat", "lookAt"):
            origin = _vec(child.attrib["origin"], subst)
            target = _vec(child.attrib["target"], subst)
            up = _vec(child.attrib.get("up", "0, 1, 0"), subst)
            t = sensorlib.look_at(origin, target, up)
        elif tag == "matrix":
            vals = [_f(v, subst) for v in child.attrib["value"].replace(",", " ").split()]
            t = np.asarray(vals, np.float32).reshape(4, 4)
        else:
            raise ValueError(f"unsupported transform tag <{tag}>")
        m = t @ m
    return m


def _f(s, subst):
    s = _substitute(s, subst)
    return float(s)


def _fattr(node, key, default, subst):
    return _f(node.attrib.get(key, str(default)), subst)


def _vec(s, subst):
    s = _substitute(s, subst)
    parts = s.replace(",", " ").split()
    v = [float(p) for p in parts]
    if len(v) == 1:
        v = v * 3
    return np.asarray(v, np.float32)


def _substitute(s, subst):
    if "$" in s:
        for k, v in subst.items():
            s = s.replace(f"${k}", str(v))
    return s


def _substitute_attributes(root, subst):
    """$key in every attribute value below `root` (the <default> entries
    aside), as Mitsuba's SceneHandler substitutes parameters, a plugin's
    type included (`<film type="$film">`). The JAX loader substitutes
    property values only (ROADMAP C35)."""
    for el in root.iter():
        if el.tag == "default":
            continue
        for k, v in el.attrib.items():
            if "$" in v:
                el.attrib[k] = _substitute(v, subst)


def _lerp_transform(m0: np.ndarray, m1: np.ndarray, t: float) -> np.ndarray:
    """Interpolate two rigid(ish) transforms at time t (track.h
    AnimatedTransform::eval): rotation via polar decomposition +
    re-orthonormalized lerp (small-angle slerp equivalent), stretch and
    translation lerped linearly."""
    if t <= 0.0:
        return np.asarray(m0, np.float32)
    if t >= 1.0:
        return np.asarray(m1, np.float32)

    def polar(a):
        u, s, vt = np.linalg.svd(a)
        return u @ vt, vt.T @ np.diag(s) @ vt

    r0, p0 = polar(m0[:3, :3])
    r1, p1 = polar(m1[:3, :3])
    u, _, vt = np.linalg.svd((1 - t) * r0 + t * r1)
    r = u @ vt
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r @ ((1 - t) * p0 + t * p1)
    out[:3, 3] = (1 - t) * m0[:3, 3] + t * m1[:3, 3]
    return out


class _Props(dict):
    """Properties dict that records which keys a plugin converter reads.
    The schema-validation analog of the reference's scene.xsd +
    Properties::markQueried / unqueried-parameter warnings
    (properties.h:46, scenehandler.cpp validation): any property no
    converter consumed is a typo, an unsupported parameter, or a
    conflicting specification, and load_xml raises at the end listing
    it with its plugin context."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.queried = set()
        self.context = ""

    def __getitem__(self, k):
        self.queried.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.queried.add(k)
        return super().get(k, default)

    def __contains__(self, k):
        self.queried.add(k)
        return super().__contains__(k)

    def unqueried(self):
        out = []
        for k in self.keys():
            if k in self.queried or k.startswith("_"):
                continue
            v = super().__getitem__(k)
            # nested <texture>/<ref> children are consumed structurally
            # (converters walk node.children), not through this dict
            if isinstance(v, tuple) and len(v) == 2 \
                    and v[0] in ("texture", "ref"):
                continue
            out.append(k)
        return out


def _props(node, subst, sink: list):
    """Collect child <integer/float/boolean/string/spectrum/rgb/point/vector
    /transform/texture/ref> tags into a dict (Properties analog), appended
    to `sink`, the load's list for the unused-property check."""
    p = _Props()
    p.context = f"<{node.tag} type=\"{node.attrib.get('type', '?')}\">"
    sink.append(p)
    for child in node:
        name = child.attrib.get("name", "")
        tag = child.tag
        if tag == "integer":
            p[name] = int(_f(child.attrib["value"], subst))
        elif tag == "float":
            p[name] = _f(child.attrib["value"], subst)
        elif tag == "boolean":
            p[name] = _substitute(child.attrib["value"], subst).lower() == "true"
        elif tag == "string":
            p[name] = _substitute(child.attrib["value"], subst)
        elif tag in ("spectrum", "rgb", "srgb"):
            v = _vec(child.attrib["value"], subst)
            if tag == "srgb":
                v = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
            p[name] = v
        elif tag == "blackbody":
            # <blackbody temperature=".." [scale=".."]/> — Planck SPD
            # projected to linear sRGB through the camera response
            # (scenehandler.cpp:100 EBlackBody; core/spectrum.py planck)
            from ..core import spectrum as speclib

            temp = _f(child.attrib["temperature"], subst)
            scale = _fattr(child, "scale", 1.0, subst)
            lam = np.linspace(speclib.LAMBDA_MIN, speclib.LAMBDA_MAX, 256)
            lam_t = torch.as_tensor(lam, dtype=torch.float32)
            spd = speclib.planck(lam_t, temp).numpy()
            resp = speclib.rgb_response(lam_t).numpy()
            rgb = speclib.trapezoid(resp * spd[:, None], lam, axis=0)
            p[name] = (rgb * scale).astype(np.float32)
        elif tag in ("point", "vector"):
            p[name] = np.asarray(
                [_fattr(child, k, 0.0, subst) for k in "xyz"], np.float32
            )
        elif tag == "transform":
            p[name] = _parse_transform(child, subst)
        elif tag == "texture":
            p[name] = ("texture", child)
        elif tag == "ref":
            p[name or "_ref"] = ("ref", child.attrib["id"])
        else:
            p.setdefault("_children", []).append(child)
    return p




# named IOR lookup (src/bsdfs/ior.h iorData — published measurements at
# ~589 nm, Hecht, Optics 4th ed.)
_IOR_NAMES = {
    "vacuum": 1.0, "helium": 1.000036, "hydrogen": 1.000132,
    "air": 1.000277, "carbon dioxide": 1.00045,
    "water": 1.3330, "acetone": 1.36, "ethanol": 1.361,
    "carbon tetrachloride": 1.461, "glycerol": 1.4729, "benzene": 1.501,
    "silicone oil": 1.52045, "bromine": 1.661,
    "water ice": 1.31, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "bk7": 1.5046,
    "sodium chloride": 1.544, "amber": 1.55, "pet": 1.5750,
    "diamond": 2.419,
}


def _ior(v):
    """intIOR/extIOR accept a number or a material name (ior.h
    lookupIOR)."""
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            pass
        name = v.strip().lower()
        if name not in _IOR_NAMES:
            raise ValueError(f"unknown IOR material name '{v}'")
        return _IOR_NAMES[name]
    return float(v)


# ---------------------------------------------------------------------------
# BSDF conversion (plugin name -> material record)
# ---------------------------------------------------------------------------

_DIST = {"beckmann": ir.MICROFACET_BECKMANN, "ggx": ir.MICROFACET_GGX,
         "phong": ir.MICROFACET_GGX}

# conductor material presets (subset of data/ior/*.spd; values at RGB)
_CONDUCTORS = {
    "cu": ([0.2, 0.92, 1.1], [3.9, 2.45, 2.14]),
    "au": ([0.143, 0.375, 1.44], [3.98, 2.39, 1.60]),
    "ag": ([0.155, 0.116, 0.138], [4.82, 3.12, 2.14]),
    "al": ([1.66, 0.88, 0.52], [9.22, 6.27, 4.84]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}


class _Loader:
    def __init__(self, base_dir: Path, subst: dict,
                 search_paths: list | None = None, time: float = 0.0,
                 device="cuda"):
        self.base = base_dir
        self.subst = subst
        self.search_paths = list(search_paths or [])
        self.time = float(time)
        self.device = device
        self.all_props: list = []      # every _Props of this load
        self._flip_pending = False
        self.test_phases: list = []
        self.materials: list[dict] = []
        # irawan cloth: slot entries (pattern, repeatU, repeatV) and
        # material-id -> slot map (models/cloth.py build_tables)
        self.cloth_entries: list = []
        self.cloth_slots: dict = {}
        self.mat_ids: dict[str, int] = {}
        self.textures: list[dict] = []
        self.verts: list = []
        self.normals: list = []
        self.uvs: list = []
        self.tris: list = []
        self.tri_mat: list = []
        self.tri_rad: dict = {}
        self.env_radiance = None
        self.delta_emitters: list = []
        self.shape_groups: dict = {}   # id -> list of raw (v,f,n,uv,mat,rad)
        self.cam = None
        self.cfg_kw: dict = {}
        self.width = 256
        self.height = 256
        self.integrator = "path"
        self.vert_colors: list = []    # per-vertex RGB (TEX_VERTEXCOLOR)
        self.any_vert_colors = False
        self.wire_params = None        # wireframe texture params
        self.curvature_req = None      # ("mean"|"gaussian", scale)
        self.medium = None             # scene/global participating medium
        self.medium_tris: list = []    # triangle ids bounding an interior
        self.medium_ids: dict = {}     # id -> Medium (for <ref>)

    def props(self, node) -> _Props:
        return _props(node, self.subst, self.all_props)

    def unused_properties(self) -> list:
        """One line per property no converter read, with its plugin."""
        return [f"{pr.context}: unknown or unused property '{k}'"
                for pr in self.all_props for k in pr.unqueried()]

    def resolve(self, filename) -> str:
        """FileResolver analog (fresolver.h): user-prepended search
        paths (the CLI's -a flag, mitsuba.cpp:159 prependPath), then the
        scene dir, the path as given (absolute / cwd-relative), and the
        bare basename in the scene dir (reference fixtures use
        repo-root-relative paths like 'data/tests/envmap.exr' next to
        the scene file)."""
        cands = [Path(p) / str(filename) for p in self.search_paths] + [
            self.base / str(filename), Path(str(filename)),
            self.base / Path(str(filename)).name]
        for c in cands:
            if c.exists():
                return str(c)
        return str(cands[-3])  # let the open() error carry this path

    # --- media ---------------------------------------------------------
    def _convert_phase(self, child):
        """<phase type="..."> -> (kind, g, static params tuple)
        (src/phase/ plugin parity; see models/phase.py docstring)."""
        from ..models import phase as phaselib

        pt = child.attrib["type"]
        pp = self.props(child)
        if pt == "hg":
            return phaselib.PHASE_HG, float(pp.get("g", 0.0)), ()
        if pt == "isotropic":
            return phaselib.PHASE_ISOTROPIC, 0.0, ()
        if pt == "rayleigh":
            return phaselib.PHASE_RAYLEIGH, 0.0, ()
        if pt == "microflake":
            ax = pp.get("orientation", [0.0, 0.0, 1.0])
            params = phaselib.make_microflake_params(
                float(pp.get("stddev", 0.1)),
                (float(ax[0]), float(ax[1]), float(ax[2])))
            return phaselib.PHASE_MICROFLAKE, 0.0, params
        if pt == "kkay":
            ax = pp.get("orientation", [0.0, 0.0, 1.0])
            params = (float(ax[0]), float(ax[1]), float(ax[2]),
                      float(pp.get("ks", 0.4)), float(pp.get("kd", 0.2)),
                      float(pp.get("exponent", 4.0)))
            return phaselib.PHASE_KKAY, 0.0, params
        if pt == "mixturephase":
            weights = [float(w) for w in
                       str(pp.get("weights", "")).replace(",", " ").split()]
            kids = [c for c in child if c.tag == "phase"]
            if len(kids) != 2 or len(weights) != 2:
                raise ValueError(
                    "mixturephase needs exactly two nested <phase> children "
                    "and a 2-entry weights string")
            (ka, ga, pa), (kb, gb, pb) = (self._convert_phase(k)
                                          for k in kids)
            if pa or pb or phaselib.PHASE_MIXTURE in (ka, kb):
                raise ValueError("mixturephase children must be analytic "
                                 "(isotropic/hg/rayleigh), not nested "
                                 "mixtures or kkay")
            return (phaselib.PHASE_MIXTURE, 0.0,
                    (ka, weights[0], ga, kb, weights[1], gb))
        raise ValueError(f"unsupported phase plugin '{pt}'")

    def convert_medium(self, node):
        """<medium type="homogeneous|heterogeneous"> -> models.medium.Medium
        (medium.h:120 plugin parity). Heterogeneous parses a nested
        gridvolume/constvolume density (src/volume/)."""
        from ..models import medium as medlib, phase as phaselib

        typ = node.attrib["type"]
        p = self.props(node)
        g = 0.0
        phase = phaselib.PHASE_ISOTROPIC
        phase_params: tuple = ()
        for child in node:
            if child.tag == "phase":
                phase, g, phase_params = self._convert_phase(child)
        scale = float(p.get("scale", 1.0))
        if typ == "homogeneous":
            if "sigmaT" in p:
                sig_t = np.asarray(p["sigmaT"], np.float32) * scale
                alb = np.asarray(p.get("albedo", [0.8] * 3), np.float32)
                sig_s = sig_t * alb
                sig_a = sig_t - sig_s
            else:
                sig_s = np.asarray(p.get("sigmaS", [1.0] * 3), np.float32) * scale
                sig_a = np.asarray(p.get("sigmaA", [0.1] * 3), np.float32) * scale
            med = medlib.make_homogeneous(sig_s, sig_a, g=g, phase=phase,
                                          phase_params=phase_params,
                                          device=self.device)
        elif typ == "heterogeneous":
            dens = None
            orientation = None
            box_min, box_max = (0, 0, 0), (1, 1, 1)
            for child in node:
                if child.tag == "volume" and \
                        child.attrib.get("name") == "orientation":
                    # per-voxel fiber axes for kkay/microflake phases
                    # (heterogeneous.cpp m_orientation)
                    vt = child.attrib["type"]
                    vp = self.props(child)
                    if vt == "gridvolume":
                        from ..io import vol as vollib
                        orientation, _, _ = vollib.read_vol(
                            self.resolve(vp["filename"]))
                        if orientation.ndim != 4 or \
                                orientation.shape[-1] != 3:
                            raise ValueError(
                                "orientation volume must have 3 channels")
                    elif vt == "constvolume":
                        v = np.asarray(vp.get("value", [0, 0, 1]),
                                       np.float32).reshape(3)
                        orientation = np.broadcast_to(
                            v, (2, 2, 2, 3)).copy()
                    else:
                        raise ValueError(
                            f"unsupported orientation volume '{vt}'")
                    continue
                if child.tag == "volume" and \
                        child.attrib.get("name", "density") == "density":
                    vt = child.attrib["type"]
                    vp = self.props(child)
                    if vt == "gridvolume":
                        from ..io import vol as vollib
                        dens, box_min, box_max = vollib.read_vol(
                            self.resolve(vp["filename"]))
                        if dens.ndim == 4:
                            dens = dens.mean(-1)
                    elif vt == "hgridvolume":
                        # block-sparse hierarchical grid (hgridvolume.cpp)
                        from ..io import vol as vollib
                        dens, box_min, box_max = None, None, None
                        tbl, blocks, bmin, bmax = vollib.read_hgrid(
                            self.resolve(vp["filename"]),
                            vp.get("prefix", ""),
                            vp.get("postfix", ".vol"))
                        alb = p.get("albedo", [0.8] * 3)
                        if isinstance(alb, (list, tuple, np.ndarray)):
                            alb = np.asarray(alb, np.float32)
                        med = medlib.make_hgrid(
                            tbl, blocks, scale, alb, g=g,
                            box_min=bmin, box_max=bmax,
                            phase=phase, phase_params=phase_params,
                            device=self.device)
                        if "id" in node.attrib:
                            self.medium_ids[node.attrib["id"]] = med
                        return med
                    elif vt == "constvolume":
                        v = vp.get("value", 1.0)
                        if isinstance(v, (list, tuple, np.ndarray)):
                            v = float(np.mean(v))
                        dens = np.full((2, 2, 2), float(v), np.float32)
                        box_min, box_max = (-1e4,) * 3, (1e4,) * 3
                    else:
                        raise ValueError(f"unsupported volume plugin '{vt}'")
            if dens is None:
                raise ValueError("heterogeneous medium without a density volume")
            alb = p.get("albedo", [0.8] * 3)
            if isinstance(alb, (list, tuple, np.ndarray)):
                alb = np.asarray(alb, np.float32)
            med = medlib.make_grid(dens, scale, alb, g=g,
                                   box_min=box_min, box_max=box_max,
                                   phase=phase, phase_params=phase_params,
                                   orientation=orientation,
                                   device=self.device)
        else:
            raise ValueError(f"unsupported medium plugin '{typ}'")
        if "id" in node.attrib:
            self.medium_ids[node.attrib["id"]] = med
        return med

    def attach_interior(self, node, med, t0):
        """Bind `med` as the interior of the shape whose triangles are
        [t0, len(tris)). Per-shape media compile to SPATIAL density
        fields (scene/voxelize.py) instead of per-ray medium pointers
        (medium.h:103): homogeneous interiors are voxelized into a grid
        over the shape volume so delta/ratio tracking respects the
        boundary statelessly; the boundary itself defaults to an
        index-matched null interface when no BSDF is given (shape.h
        interior-medium semantics)."""
        from ..models import medium as medlib
        from . import voxelize as voxlib

        t1 = len(self.tris)
        has_bsdf = any(
            s.tag == "bsdf" or (s.tag == "ref" and "name" not in s.attrib)
            for s in node)
        if not has_bsdf:
            null_id = len(self.materials)
            self.materials.append({"type": ir.BSDF_NULL})
            for i in range(t0, t1):
                self.tri_mat[i] = null_id
        if med.kind == medlib.MEDIUM_HOMOGENEOUS:
            tris = np.asarray(self.tris[t0:t1], np.int64)
            verts = np.asarray(self.verts, np.float64)
            dens, lo, hi = voxlib.voxelize(verts, tris, res=48)
            med = medlib.Medium(
                sigma_t=med.sigma_t, albedo=med.albedo, g=med.g,
                density=torch.as_tensor(dens, device=self.device),
                box_min=torch.as_tensor(lo, device=self.device),
                box_max=torch.as_tensor(hi, device=self.device),
                kind=medlib.MEDIUM_GRID, phase=med.phase)
        if self.medium is not None and self.medium is not med:
            raise ValueError(
                "only one participating medium per scene is supported")
        self.medium = med
        self.medium_tris.extend(range(t0, t1))

    # --- textures ------------------------------------------------------
    def load_texture(self, node) -> int:
        from ..models import texture as texlib
        from ..io import image as imagelib

        typ = node.attrib["type"]
        p = self.props(node)
        if typ == "scale":
            # src/textures/scale.cpp: multiply a nested texture/constant by
            # a factor — flattened at load by pre-multiplying the texels
            factor = p.get("scale", 1.0)
            if isinstance(factor, (list, tuple, np.ndarray)):
                factor = np.asarray(factor, np.float32)
            nested = [c for c in node if c.tag == "texture"]
            if not nested:
                raise ValueError("scale texture without nested texture")
            tid = self.load_texture(nested[0])
            if tid < 0:
                raise ValueError("scale over procedural textures unsupported")
            self.textures[tid]["data"] = (
                np.asarray(self.textures[tid]["data"], np.float32) * factor)
            return tid
        if typ == "vertexcolors":
            # src/textures/vertexcolors.cpp: barycentric per-vertex colors
            return ir.TEX_VERTEXCOLOR
        if typ == "wireframe":
            # src/textures/wireframe.cpp (edge width in barycentric units)
            interior = np.asarray(p.get("interiorColor", [0.5] * 3), np.float32)
            edge = np.asarray(p.get("edgeColor", [0.1] * 3), np.float32)
            width = float(p.get("lineWidth", 0.01)) * 10.0  # bary-space scale
            self.wire_params = np.concatenate(
                [interior, edge, [width]]).astype(np.float32)
            return ir.TEX_WIREFRAME
        if typ == "curvature":
            # src/textures/curvature.cpp: bake per-vertex curvature colors
            # after all shapes load (see _finish)
            self.curvature_req = (str(p.get("curvature", "gaussian")),
                                  float(p.get("scale", 1.0)))
            return ir.TEX_VERTEXCOLOR
        if typ == "gridtexture":
            # src/textures/gridtexture.cpp: lines of color1 on color0 —
            # rasterized once into a nearest bitmap (equivalent under
            # repeat tiling at the stored resolution)
            c0 = np.asarray(p.get("color0", [0.2] * 3), np.float32)
            c1 = np.asarray(p.get("color1", [0.4] * 3), np.float32)
            lw = float(p.get("lineWidth", 0.01))
            res = 64
            img = np.tile(c0, (res, res, 1)).astype(np.float32)
            k = max(1, int(round(lw * res)))
            img[:k, :, :] = c1
            img[:, :k, :] = c1
            rec = {"data": img, "nearest": True,
                   "transform": (p.get("uscale", 1.0), p.get("vscale", 1.0),
                                 p.get("uoffset", 0.0), p.get("voffset", 0.0))}
            self.textures.append(rec)
            return len(self.textures) - 1
        if typ == "bitmap":
            fn = Path(self.resolve(p["filename"]))
            data = imagelib.read_auto(str(fn))
            rec = {"data": data,
                   "transform": (p.get("uscale", 1.0), p.get("vscale", 1.0),
                                 p.get("uoffset", 0.0), p.get("voffset", 0.0))}
        elif typ == "checkerboard":
            rec = texlib.checkerboard(
                p.get("color0", np.asarray([0.4] * 3, np.float32)),
                p.get("color1", np.asarray([0.2] * 3, np.float32)),
            )
            rec["transform"] = (2.0 * p.get("uscale", 1.0), 2.0 * p.get("vscale", 1.0),
                                p.get("uoffset", 0.0), p.get("voffset", 0.0))
        else:
            raise ValueError(f"unsupported texture plugin '{typ}'")
        self.textures.append(rec)
        return len(self.textures) - 1

    # --- BSDFs ---------------------------------------------------------
    def convert_bsdf(self, node) -> int:
        typ = node.attrib["type"]
        p = self.props(node)
        rec: dict = {}

        def refl(key="reflectance", default=(0.5, 0.5, 0.5)):
            val = p.get(key, p.get("diffuseReflectance", np.asarray(default, np.float32)))
            if isinstance(val, tuple) and val[0] == "texture":
                rec["tex_reflectance"] = self.load_texture(val[1])
                return np.asarray([1.0, 1.0, 1.0], np.float32)
            return np.asarray(val, np.float32)

        def alpha_of(default=0.1):
            a = p.get("alpha", default)
            au = p.get("alphaU", a)
            av = p.get("alphaV", a)
            return [float(au), float(av)]

        dist = _DIST.get(str(p.get("distribution", "beckmann")), ir.MICROFACET_BECKMANN)
        eta_d = _ior(p.get("intIOR", 1.5046)) / _ior(p.get("extIOR", 1.000277))

        if typ == "diffuse":
            rec.update(type=ir.BSDF_DIFFUSE, reflectance=refl())
        elif typ == "roughdiffuse":
            rec.update(type=ir.BSDF_ROUGH_DIFFUSE, reflectance=refl(),
                       alpha=alpha_of(0.2))
        elif typ in ("conductor", "roughconductor"):
            mat = str(p.get("material", "cu")).lower()
            eta, k = _CONDUCTORS.get(mat, _CONDUCTORS["cu"])
            eta = p.get("eta", np.asarray(eta, np.float32))
            k = p.get("k", np.asarray(k, np.float32))
            rec.update(eta=np.asarray(eta, np.float32), k=np.asarray(k, np.float32),
                       specular=p.get("specularReflectance", np.ones(3, np.float32)))
            if typ == "conductor":
                rec["type"] = ir.BSDF_CONDUCTOR
            else:
                rec.update(type=ir.BSDF_ROUGH_CONDUCTOR, alpha=alpha_of(),
                           extra=[0, 0, 0, dist])
        elif typ in ("dielectric", "roughdielectric", "thindielectric"):
            if "cauchyB" in p:
                # dispersive glass: picked up by the spectral integrator
                # (RGB renders ignore it, like the reference's RGB build)
                self.cfg_kw["cauchy_b"] = float(p["cauchyB"])
            rec.update(eta=[eta_d] * 3,
                       specular=p.get("specularReflectance", np.ones(3, np.float32)),
                       reflectance=p.get("specularTransmittance", np.ones(3, np.float32)))
            if typ == "thindielectric":
                rec["type"] = ir.BSDF_THIN_DIELECTRIC
            elif typ == "dielectric":
                rec["type"] = ir.BSDF_DIELECTRIC
            else:
                rec.update(type=ir.BSDF_ROUGH_DIELECTRIC, alpha=alpha_of(),
                           extra=[0, 0, 0, dist])
        elif typ in ("plastic", "roughplastic"):
            # `nonlinear` (and its pre-0.5 alias `preserveColors`) select
            # plastic.cpp's internal-scattering compensation mode; our
            # plastic always applies the compensation (bsdf.py:283), so
            # the flag is accepted for scene compatibility
            p.get("nonlinear")
            p.get("preserveColors")
            rec.update(type=ir.BSDF_PLASTIC if typ == "plastic" else ir.BSDF_ROUGH_PLASTIC,
                       reflectance=refl("diffuseReflectance"),
                       specular=p.get("specularReflectance", np.ones(3, np.float32)),
                       eta=[eta_d] * 3)
            if typ == "roughplastic":
                rec.update(alpha=alpha_of(), extra=[0, 0, 0, dist])
        elif typ == "phong":
            rec.update(type=ir.BSDF_PHONG, reflectance=refl("diffuseReflectance"),
                       specular=p.get("specularReflectance", np.asarray([0.2] * 3, np.float32)),
                       extra=[float(p.get("exponent", 30.0)), 0, 0, 0])
        elif typ == "difftrans":
            rec.update(type=ir.BSDF_DIFFUSE_TRANSMITTER, reflectance=refl("transmittance"))
        elif typ == "ward":
            rec.update(type=ir.BSDF_WARD,
                       reflectance=refl("diffuseReflectance"),
                       specular=p.get("specularReflectance",
                                      np.asarray([0.2] * 3, np.float32)),
                       alpha=[float(p.get("alphaU", p.get("alpha", 0.1))),
                              float(p.get("alphaV", p.get("alpha", 0.1)))])
        elif typ in ("blendbsdf", "mixturebsdf"):
            inner = [c for c in node if c.tag == "bsdf"]
            refs = [c for c in node if c.tag == "ref" and "name" not in c.attrib]
            kids = [self.convert_bsdf(c) for c in inner]
            kids += [self.mat_ids[c.attrib["id"]] for c in refs]
            if len(kids) < 2:
                raise ValueError(f"{typ} needs two nested bsdfs")
            if typ == "blendbsdf":
                wgt = float(p.get("weight", 0.5))
            else:
                ws = [float(x) for x in str(p.get("weights", "0.5, 0.5")).replace(",", " ").split()]
                wgt = ws[0] / max(sum(ws[:2]), 1e-9)
            rec.update(type=ir.BSDF_BLEND, nested=(kids[0], kids[1]),
                       extra=[wgt, 0, 0, 0])
        elif typ in ("coating", "roughcoating"):
            # src/bsdfs/{coating,roughcoating}.cpp: Weidlich-Wilkie coat
            # over a one-level nested child (models/bsdf.py BSDF_COATING)
            inner = [c for c in node if c.tag == "bsdf"]
            refs = [c for c in node if c.tag == "ref" and "name" not in c.attrib]
            if inner:
                child = self.convert_bsdf(inner[0])
            elif refs:
                child = self.mat_ids[refs[0].attrib["id"]]
            else:
                raise ValueError(f"{typ} without nested bsdf")
            sigma_a = np.asarray(p.get("sigmaA", [0.0] * 3), np.float32) \
                * np.float32(p.get("thickness", 1.0))
            avg_absorb = float(np.mean(np.exp(-2.0 * sigma_a)))
            w_spec = 1.0 / (avg_absorb + 1.0)
            alpha_c = float(p.get("alpha", 0.1)) if typ == "roughcoating" \
                else 0.0
            rec.update(type=ir.BSDF_COATING, nested=(child, -1),
                       reflectance=sigma_a,
                       specular=p.get("specularReflectance",
                                      np.ones(3, np.float32)),
                       eta=[eta_d] * 3, alpha=[alpha_c, alpha_c],
                       extra=[w_spec, 0, 0, dist])
        elif typ == "hk":
            # src/bsdfs/hk.cpp: sigmaS&sigmaA or sigmaT&albedo conventions
            thick = np.float32(p.get("thickness", 1.0))
            if "sigmaT" in p:
                sig_t = np.asarray(p["sigmaT"], np.float32)
                alb = np.asarray(p.get("albedo", [0.8] * 3), np.float32)
                sig_s = sig_t * alb
                sig_a = sig_t - sig_s
            else:
                sig_s = np.asarray(p.get("sigmaS", [2.0] * 3), np.float32)
                sig_a = np.asarray(p.get("sigmaA", [0.1] * 3), np.float32)
            g = 0.0
            for child in node:
                if child.tag == "phase" and child.attrib["type"] == "hg":
                    g = float(self.props(child).get("g", 0.0))
            rec.update(type=ir.BSDF_HK, reflectance=sig_s * thick,
                       specular=sig_a * thick, extra=[g, 0, 0, 0])
        elif typ == "null":
            rec.update(type=ir.BSDF_NULL)
        elif typ == "twosided":
            # adapter: mark nested bsdf as twosided via extra[2]
            inner = [c for c in node if c.tag == "bsdf"]
            refs = [c for c in node if c.tag == "ref"]
            if inner:
                mid = self.convert_bsdf(inner[0])
            elif refs:
                mid = self.mat_ids[refs[0].attrib["id"]]
            else:
                raise ValueError("twosided without nested bsdf")
            self.materials[mid]["extra"] = list(self.materials[mid].get("extra", [0, 0, 0, 0]))
            self.materials[mid]["extra"][2] = 1.0
            if "id" in node.attrib:
                self.mat_ids[node.attrib["id"]] = mid
            return mid
        elif typ == "mask":
            # src/bsdfs/mask.cpp: opacity-blend of the nested bsdf with a
            # null pass-through — expressed as the BLEND adapter picking
            # the child with prob extra[0]=opacity, else a NULL row
            inner = [c for c in node if c.tag == "bsdf"]
            refs = [c for c in node if c.tag == "ref"]
            if inner:
                child = self.convert_bsdf(inner[0])
            elif refs:
                child = self.mat_ids[refs[0].attrib["id"]]
            else:
                raise ValueError("mask without nested bsdf")
            op = p.get("opacity", 0.5)
            op_tex = None
            if isinstance(op, tuple) and op and op[0] == "texture":
                # mask.cpp accepts a texture for the opacity; the blend
                # row's (otherwise unused) tex_reflectance slot carries
                # it and gather_shade_point evaluates it per lane
                op_tex = self.load_texture(op[1])
                op = 0.5
            elif isinstance(op, (list, tuple, np.ndarray)):
                op = float(np.mean(op))
            else:
                op = float(op)
            null_id = len(self.materials)
            self.materials.append({"type": ir.BSDF_NULL})
            mid = len(self.materials)
            rec_mask = {"type": ir.BSDF_BLEND,
                        "nested": [child, null_id],
                        "extra": [op, 0.0, 0.0, 0.0]}
            if op_tex is not None:
                rec_mask["tex_reflectance"] = op_tex
            self.materials.append(rec_mask)
            if "id" in node.attrib:
                self.mat_ids[node.attrib["id"]] = mid
            return mid
        elif typ == "irawan":
            # woven cloth (src/bsdfs/irawan.cpp): weave pattern file (or a
            # named built-in preset) + repeatU/repeatV tiling
            from ..models import cloth as clothlib

            if "filename" in p:
                text = Path(self.resolve(p["filename"])).read_text()
            else:
                preset = str(p.get("preset", "cotton"))
                if preset not in clothlib.PRESETS:
                    raise ValueError(f"unknown irawan preset '{preset}'")
                text = clothlib.PRESETS[preset]
            scalar_props = {k: v for k, v in p.items()
                            if isinstance(v, (int, float))}
            pat = clothlib.parse_weave(text, scalar_props)
            clothlib.compute_normalization(pat)
            slot = len(self.cloth_entries)
            self.cloth_entries.append(
                (pat, float(p.get("repeatU", 1.0)),
                 float(p.get("repeatV", 1.0))))
            mid = len(self.materials)
            self.materials.append({"type": ir.BSDF_IRAWAN})
            self.cloth_slots[mid] = slot
            if "id" in node.attrib:
                self.mat_ids[node.attrib["id"]] = mid
            return mid
        elif typ in ("bumpmap", "normalmap"):
            # adapters (src/bsdfs/{bumpmap,normalmap}.cpp): annotate the
            # nested bsdf with a perturb map; the shading-normal rotation
            # happens once in surface_interaction (ops/intersect.py)
            inner = [c for c in node if c.tag == "bsdf"]
            refs = [c for c in node if c.tag == "ref"]
            texn = [c for c in node if c.tag == "texture"]
            if inner:
                mid = self.convert_bsdf(inner[0])
            elif refs:
                mid = self.mat_ids[refs[0].attrib["id"]]
            else:
                raise ValueError(f"{typ} without nested bsdf")
            if not texn:
                raise ValueError(f"{typ} without a texture")
            self.materials[mid]["tex_perturb"] = self.load_texture(texn[0])
            self.materials[mid]["perturb_kind"] = 2 if typ == "bumpmap" else 1
            if "id" in node.attrib:
                self.mat_ids[node.attrib["id"]] = mid
            return mid
        else:
            raise ValueError(f"unsupported bsdf plugin '{typ}'")

        self.materials.append(rec)
        mid = len(self.materials) - 1
        if "id" in node.attrib:
            self.mat_ids[node.attrib["id"]] = mid
        return mid

    # --- shapes --------------------------------------------------------
    def add_mesh(self, verts, faces, mat_id, normals=None, uvs=None, radiance=None,
                 colors=None):
        base = len(self.verts)
        self.verts.extend(np.asarray(verts, np.float32))
        if normals is None:
            normals = np.zeros_like(np.asarray(verts, np.float32))
        self.normals.extend(np.asarray(normals, np.float32))
        if uvs is None:
            uvs = np.zeros((len(verts), 2), np.float32)
        self.uvs.extend(np.asarray(uvs, np.float32))
        if colors is None:
            colors = np.full((len(verts), 3), 0.5, np.float32)
        else:
            self.any_vert_colors = True
        self.vert_colors.extend(np.asarray(colors, np.float32))
        for f in np.asarray(faces, np.int32):
            if radiance is not None:
                self.tri_rad[len(self.tris)] = radiance
            self.tris.append([f[0] + base, f[1] + base, f[2] + base])
            self.tri_mat.append(mat_id)

    def convert_shape(self, node, collect_to=None):
        """collect_to: when set (shapegroup definition), meshes are stored
        in that list instead of the scene (shapegroup.cpp semantics)."""
        typ = node.attrib["type"]
        p = self.props(node)
        # interior/exterior medium refs are consumed by the caller's
        # child-node walk (_process_children), not through this dict
        p.get("interior")
        p.get("exterior")
        self._flip_pending = bool(p.get("flipNormals", False))
        to_world = p.get("toWorld", np.eye(4, dtype=np.float32))
        # animated object transform (track.h AnimatedTransform with two
        # keyframes): evaluate at the loader's shutter time
        if "toWorldEnd" in p:
            to_world = _lerp_transform(
                np.asarray(to_world, np.float32),
                np.asarray(p["toWorldEnd"], np.float32),
                self.time)

        if typ == "shapegroup":
            group: list = []
            for child in node:
                if child.tag == "shape":
                    self.convert_shape(child, collect_to=group)
            self.shape_groups[node.attrib.get("id", "")] = group
            return
        if typ == "instance":
            refs = [c for c in node if c.tag == "ref"]
            if not refs or refs[0].attrib["id"] not in self.shape_groups:
                raise ValueError("instance requires a <ref> to a shapegroup")
            # flattened IR: instancing = re-emission of the group's meshes
            # under this instance's transform (trades memory for the
            # zero-indirection wavefront; shapegroup/instance.cpp keeps a
            # kd-tree per group instead)
            for (v, f, n, uv, mat_id, radiance) in self.shape_groups[refs[0].attrib["id"]]:
                v2, n2 = shapelib.apply_transform(to_world, v, n)
                f2 = f
                if np.linalg.det(np.asarray(to_world)[:3, :3]) < 0:
                    f2 = np.asarray(f)[:, ::-1]
                self.add_mesh(v2, f2, mat_id, normals=n2, uvs=uv,
                              radiance=radiance)
            return
        if typ == "heightfield":
            from ..io import image as imagelib
            data = imagelib.read_auto(self.resolve(p["filename"])) \
                if "filename" in p else None
            hscale = float(p.get("scale", 1.0))
            res = int(p.get("resolution", 64))
            if data is None:
                hgt = np.zeros((res, res), np.float32)
            else:
                hgt = np.asarray(data, np.float32)
                if hgt.ndim == 3:
                    hgt = hgt.mean(-1)
            v, f, n, uv = shapelib.heightfield(hgt, hscale)
            mat_id, _ = self._shape_material(node)
            v2, n2 = shapelib.apply_transform(to_world, v, n)
            self.add_mesh(v2, f, mat_id, normals=n2, uvs=uv)
            return

        mat_id, radiance = self._shape_material(node)
        mesh_colors = None

        if typ == "rectangle":
            v, f, n, uv = shapelib.rectangle()
        elif typ == "cube":
            v, f, n, uv = shapelib.cube()
        elif typ == "sphere":
            center = p.get("center", np.zeros(3, np.float32))
            radius = float(p.get("radius", 1.0))
            v, f, n, uv = shapelib.sphere(center, radius)
        elif typ == "disk":
            v, f, n, uv = shapelib.disk()
        elif typ == "cylinder":
            v, f, n, uv = shapelib.cylinder(
                p.get("p0", np.asarray([0, 0, 0], np.float32)),
                p.get("p1", np.asarray([0, 0, 1], np.float32)),
                float(p.get("radius", 1.0)),
            )
        elif typ == "hair":
            # src/shapes/hair.cpp: fiber curves -> triangle tubes at load
            from ..io import hair as hairlib
            strands = hairlib.read_hair(self.resolve(p["filename"]))
            radius = float(p.get("radius", 0.025))
            red = float(p.get("reduction", 0.0))
            if red > 0:
                rng = np.random.RandomState(0)
                strands = [st for st in strands if rng.rand() >= red]
            v, f, n, uv = shapelib.hair_tubes(strands, radius)
            mat_id, _ = self._shape_material(node)
            v2, n2 = shapelib.apply_transform(to_world, v, n)
            self.add_mesh(v2, f, mat_id, normals=n2, uvs=uv)
            return
        elif typ == "deformable":
            # src/shapes/deformable.cpp: vertex-keyframed mesh; where the
            # reference builds a space-time kd-tree, this loader lerps
            # the two topologically identical keyframe meshes at the
            # loader's shutter time (time-binned rendering loads once
            # per bin)
            from ..io import mesh as meshlib

            def _load_any(fn):
                fn = self.base / fn
                return (meshlib.load_obj(fn) if str(fn).endswith(".obj")
                        else meshlib.load_ply(fn))

            md0 = _load_any(p["filename0"])
            md1 = _load_any(p["filename1"])
            if md0.vertices.shape != md1.vertices.shape or \
                    not np.array_equal(md0.indices, md1.indices):
                raise ValueError("deformable keyframes must share topology")
            t = self.time
            v = (1.0 - t) * md0.vertices + t * md1.vertices
            f = md0.indices
            n0 = md0.normals if md0.normals is not None else np.zeros_like(v)
            n1 = md1.normals if md1.normals is not None else n0
            n = (1.0 - t) * n0 + t * n1
            ln = np.linalg.norm(n, axis=1, keepdims=True)
            n = np.where(ln > 1e-9, n / np.maximum(ln, 1e-9), n)
            uv = md0.uvs if md0.uvs is not None \
                else np.zeros((len(v), 2), np.float32)
            mesh_colors = None
        elif typ in ("obj", "ply", "serialized"):
            from ..io import mesh as meshlib

            fn = Path(self.resolve(p["filename"]))
            if typ == "serialized":
                from ..io import serialized as serlib
                md = serlib.read_serialized(fn, int(p.get("shapeIndex", 0)))
            else:
                md = meshlib.load_obj(fn) if typ == "obj" else meshlib.load_ply(fn)
            v, f = md.vertices, md.indices
            n = md.normals if md.normals is not None else np.zeros_like(v)
            uv = md.uvs if md.uvs is not None else np.zeros((len(v), 2), np.float32)
            if p.get("faceNormals", False):
                n = np.zeros_like(v)
            mesh_colors = md.colors
        else:
            raise ValueError(f"unsupported shape plugin '{typ}'")

        v, n2 = shapelib.apply_transform(to_world, v, n)
        if np.linalg.det(np.asarray(to_world)[:3, :3]) < 0:
            f = np.asarray(f)[:, ::-1]  # restore winding under reflections
        has_n = np.abs(np.asarray(n)).sum() > 0
        n_out = n2 if has_n else None
        if collect_to is not None:
            collect_to.append((v, np.asarray(f), n_out, uv, mat_id, radiance))
        else:
            self.add_mesh(v, f, mat_id, normals=n_out, uvs=uv,
                          radiance=radiance, colors=mesh_colors)

    def _shape_material(self, node, default=None):
        """Nested bsdf / ref / default diffuse + optional area emitter."""
        mat_id = default
        radiance = None
        for child in node:
            if child.tag == "bsdf":
                mat_id = self.convert_bsdf(child)
            elif child.tag == "ref":
                rid = child.attrib["id"]
                if rid in self.mat_ids:
                    mat_id = self.mat_ids[rid]
            elif child.tag == "emitter":
                ep = self.props(child)
                if child.attrib["type"] == "area":
                    radiance = np.asarray(ep.get("radiance", [1, 1, 1]), np.float32)
        if mat_id is None:
            refl = [0, 0, 0] if radiance is not None else [0.5, 0.5, 0.5]
            self.materials.append({"type": ir.BSDF_DIFFUSE, "reflectance": refl})
            mat_id = len(self.materials) - 1
        return mat_id, radiance

    # --- top level -----------------------------------------------------
    def convert_sensor(self, node):
        p = self.props(node)
        typ = node.attrib["type"]
        to_world = p.get("toWorld", np.eye(4, dtype=np.float32))
        fov = float(p.get("fov", 35.0))
        spp = 16
        for child in node:
            if child.tag == "film":
                fp = self.props(child)
                self.width = int(fp.get("width", 768))
                self.height = int(fp.get("height", 576))
                fmt = str(fp.get("pixelFormat", "rgb"))
                if fmt not in ("rgb", "luminance"):
                    from ..core.logger import EWarn, get_logger
                    get_logger().log(
                        EWarn, f"film: pixelFormat '{fmt}' stored as rgb "
                        "(alpha/spectrum channels are not carried)")
                if child.attrib.get("type") == "tiledhdrfilm":
                    # streamed row-band output (films/tiledhdrfilm.cpp)
                    self.cfg_kw["film_tiled"] = True
                for fc in child:
                    if fc.tag == "rfilter":
                        from ..film import film as filmlib
                        fmap = {"box": filmlib.FILTER_BOX,
                                "tent": filmlib.FILTER_TENT,
                                "gaussian": filmlib.FILTER_GAUSSIAN,
                                "mitchell": filmlib.FILTER_MITCHELL,
                                "catmullrom": filmlib.FILTER_CATMULLROM,
                                "lanczos": filmlib.FILTER_LANCZOS}
                        ft = fc.attrib["type"]
                        if ft not in fmap:
                            raise ValueError(f"unsupported rfilter '{ft}'")
                        self.cfg_kw["filter"] = fmap[ft]
            elif child.tag == "sampler":
                sp = self.props(child)
                spp = int(sp.get("sampleCount", 16))
                kind_map = {"independent": 0, "stratified": 1, "halton": 2,
                            "ldsampler": 3, "sobol": 5, "hammersley": 4,
                            "faure": 6}
                self.cfg_kw["sampler"] = kind_map.get(child.attrib.get("type"), 0)
        self.cfg_kw["spp"] = spp
        fov_axis = p.get("fovAxis", "x")
        if fov_axis == "y":
            # convert to fov_x (sensor.py uses x)
            aspect = self.width / self.height
            fov = np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov / 2)) * aspect))
        kinds = {"perspective": sensorlib.SENSOR_PERSPECTIVE,
                 "thinlens": sensorlib.SENSOR_THINLENS,
                 "orthographic": sensorlib.SENSOR_ORTHOGRAPHIC,
                 "spherical": sensorlib.SENSOR_SPHERICAL,
                 "telecentric": sensorlib.SENSOR_TELECENTRIC,
                 "perspective_rdist": sensorlib.SENSOR_RDIST,
                 "radiancemeter": sensorlib.SENSOR_RADIANCEMETER,
                 "fluencemeter": sensorlib.SENSOR_FLUENCEMETER,
                 "irradiancemeter": sensorlib.SENSOR_IRRADIANCEMETER}
        if typ not in kinds:
            raise ValueError(f"unsupported sensor plugin '{typ}'")
        kc = [0.0, 0.0]
        if "kc" in p:
            kc = [float(x) for x in
                  str(p["kc"]).replace(",", " ").split()][:2]
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)

        # two-keyframe camera animation (track.h AnimatedTransform):
        # <transform name="toWorldEnd"> is the shutter-close pose
        to_world_end = p.get("toWorldEnd")
        self.cam = sensorlib.Camera(
            to_world=f32(to_world),
            to_world_end=None if to_world_end is None else f32(to_world_end),
            fov_x=f32(fov),
            aperture=f32(p.get("apertureRadius", 0.0)),
            focus_dist=f32(p.get("focusDistance", 1.0)),
            kc=f32(kc),
            width=self.width,
            height=self.height,
            kind=kinds[typ],
        )

    def convert_integrator(self, node):
        typ = node.attrib["type"]
        p = self.props(node)
        self.integrator = typ
        md = int(p.get("maxDepth", -1))
        self.cfg_kw["max_depth"] = 16 if md < 0 else md
        if "rrDepth" in p:
            self.cfg_kw["rr_depth"] = int(p["rrDepth"])
        if "strictNormals" in p:
            self.cfg_kw["strict_normals"] = bool(p["strictNormals"])
        if "hideEmitters" in p:
            self.cfg_kw["hide_emitters"] = bool(p["hideEmitters"])
        if typ == "direct":
            # direct.cpp's per-strategy sample counts: this integrator
            # always uses 1 emitter + 1 BSDF sample with MIS; accept the
            # parameters (legacy scenes set them) and note the fixture
            for key in ("emitterSamples", "bsdfSamples", "shadingSamples"):
                if key in p and int(p[key]) != 1:
                    from ..core.logger import EWarn, get_logger
                    get_logger().log(
                        EWarn, f"direct: {key}={p[key]} requested; this "
                        "implementation uses 1 sample per strategy "
                        "(raise spp instead)")


def load_xml(path, defaults: dict | None = None, time: float = 0.0,
             search_paths: list | None = None, device="cuda"):
    """Load a Mitsuba XML scene onto `device`.

    Returns (scene, camera, config, integrator_name). `defaults` override
    <default> declarations ($key substitution, mitsuba -D parity);
    `search_paths` are tried first when a file is resolved (mitsuba -a).

    `time` in [0, 1] evaluates animated OBJECT transforms
    (<transform name="toWorldEnd"> on shapes, track.h AnimatedTransform)
    and deformable vertex keyframes at the given shutter time: the
    CLI's --time-bins renders one load per stratified shutter time.
    """
    path = Path(path)
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "scene":
        raise ValueError("root element must be <scene>")
    # legacy scene versions: apply the upgrade chain in place
    # (data/schema/upgrade_*.xsl parity — scene/upgrade.py)
    from . import upgrade as _upgradelib
    if _upgradelib.upgrade_to_current(root):
        from ..core.logger import EInfo, get_logger
        get_logger().log(
            EInfo, f"upgraded legacy scene {path.name} to version 0.6.0")

    subst = {}
    for child in root:
        if child.tag == "default":
            subst[child.attrib["name"]] = child.attrib["value"]
    if defaults:
        subst.update(defaults)
    _substitute_attributes(root, subst)

    ld = _Loader(path.parent, subst, search_paths=search_paths, time=time,
                 device=device)
    _process_children(root, ld, subst, path.parent)
    out = _finish(ld)
    # schema validation (scene.xsd analog): every declared property must
    # have been consumed by some converter
    bad = ld.unused_properties()
    if bad:
        raise ValueError(
            "scene validation failed (unsupported/typo'd parameters):\n  "
            + "\n  ".join(bad))
    return out


def _process_children(root, ld, subst, base_dir):
    """Dispatch scene-level tags; recurses into <include> files
    (scenehandler.cpp's EIncludeDirective)."""
    for child in root:
        tag = child.tag
        if tag == "integrator":
            ld.convert_integrator(child)
        elif tag == "sensor":
            ld.convert_sensor(child)
        elif tag == "bsdf":
            ld.convert_bsdf(child)
        elif tag == "medium":
            # id-less scene-level medium = global (camera-immersed);
            # an id makes it a declaration for <ref name="interior"/>
            med = ld.convert_medium(child)
            if "id" not in child.attrib:
                ld.medium = med
        elif tag == "include":
            inc_path = base_dir / child.attrib["filename"]
            inc_root = ET.parse(inc_path).getroot()
            if inc_root.tag != "scene":
                raise ValueError(f"{inc_path}: included root must be <scene>")
            for c in inc_root:
                if c.tag == "default":
                    subst.setdefault(c.attrib["name"], c.attrib["value"])
            _substitute_attributes(inc_root, subst)
            _process_children(inc_root, ld, subst, Path(inc_path).parent)
        elif tag == "shape":
            t0 = len(ld.tris)
            ld.convert_shape(child)
            if getattr(ld, "_flip_pending", False):
                # flipNormals (shape.h m_flipNormals): reverse winding
                # so geometric normals (and one-sided emission) invert
                for ti in range(t0, len(ld.tris)):
                    a, b, c = ld.tris[ti]
                    ld.tris[ti] = [a, c, b]
                ld._flip_pending = False
            interior = None
            for sub in child:
                if sub.tag == "medium":
                    if sub.attrib.get("name", "interior") != "interior":
                        raise ValueError(
                            "only interior shape media are supported")
                    interior = ld.convert_medium(sub)
                elif sub.tag == "ref" and sub.attrib.get("name") == "interior":
                    interior = ld.medium_ids[sub.attrib["id"]]
                elif sub.tag == "ref" and sub.attrib.get("name") == "exterior":
                    # the medium surrounding the shape (medium.h:103
                    # exterior pointer): in the flattened IR the
                    # surrounding medium IS the scene's global medium, so
                    # the first exterior ref promotes its target
                    if ld.medium is None:
                        ld.medium = ld.medium_ids[sub.attrib["id"]]
            if interior is not None:
                ld.attach_interior(child, interior, t0)
        elif tag == "emitter":
            typ = child.attrib["type"]
            p = ld.props(child)
            if typ == "constant":
                ld.env_radiance = np.asarray(p.get("radiance", [1, 1, 1]), np.float32)
            elif typ == "envmap":
                from ..io import image as imagelib
                data = imagelib.read_auto(ld.resolve(p["filename"]))
                if "toWorld" in p:
                    # bake the rotation into the lat-long map
                    # (envmap.cpp m_worldTransform)
                    from . import envmap as envlib
                    data = envlib.rotate_latlong(data, p["toWorld"])
                ld.env_radiance = None
                ld.cfg_kw.setdefault("_envmap", data * float(p.get("scale", 1.0)))
            elif typ in ("point", "spot", "directional", "collimated"):
                rec = {"kind": {"point": ir.DELTA_POINT, "spot": ir.DELTA_SPOT,
                                "directional": ir.DELTA_DIRECTIONAL,
                                "collimated": ir.DELTA_COLLIMATED}[typ]}
                to_world = p.get("toWorld", np.eye(4, dtype=np.float32))
                rec["position"] = p.get("position", to_world[:3, 3])
                # spot/directional/collimated emit along +z of toWorld
                rec["direction"] = p.get("direction", to_world[:3, :3] @ np.asarray([0, 0, 1.0]))
                rec["intensity"] = p.get("intensity",
                                         p.get("irradiance",
                                               p.get("power", np.ones(3))))
                if typ == "spot":
                    co = float(p.get("cutoffAngle", 20.0))
                    rec["cutoff_deg"] = co
                    rec["beam_deg"] = float(p.get("beamWidth", co * 0.75))
                ld.delta_emitters.append(rec)
            elif typ in ("sun", "sky", "sunsky"):
                # procedural daylight baked to a lat-long envmap at load
                # time, the reference's strategy (sky.cpp bakes at
                # `resolution` in configure()); models/sunsky.py
                _daylight(ld, typ, p)
            else:
                raise ValueError(f"unsupported emitter plugin '{typ}'")
        elif tag in ("default", "alias", "null"):
            # alias only re-binds ids; ids are resolved eagerly here so a
            # pure alias is a no-op
            pass
        else:
            # chi-square test fixtures declare top-level <phase> entries
            # (data/tests/test_phase.xml, consumed by test_chisquare)
            if tag == "phase":
                ld.test_phases.append(ld._convert_phase(child))
            else:
                raise ValueError(f"unsupported scene element <{tag}>")


def _daylight(ld, typ, p):
    """A sun, sky or sunsky emitter: the sun from sunDirection, or from a
    time and place (PSA, sunmodel.h:120), never both; baked by
    models/sunsky.py with the JAX loader's defaults, plus the Hosek sky's
    band stack for the spectral renderer."""
    from ..models import sunsky as sunskylib

    if "sunDirection" in p:
        if any(k in p for k in ("latitude", "longitude", "timezone", "year", "month",
                                "day", "hour", "minute", "second")):
            raise ValueError("sunsky: give either sunDirection or time/location, "
                             "not both (sunmodel.h:216)")
        sd = p["sunDirection"]
    elif any(k in p for k in ("latitude", "longitude", "hour", "day", "month", "year")):
        sd = sunskylib.sun_direction(
            year=int(p.get("year", 2010)), month=int(p.get("month", 7)),
            day=int(p.get("day", 10)), hour=float(p.get("hour", 15.0)),
            minute=float(p.get("minute", 0.0)), second=float(p.get("second", 0.0)),
            latitude=float(p.get("latitude", 35.6894)),
            longitude=float(p.get("longitude", 139.6917)),
            timezone=float(p.get("timezone", 9.0)))
    else:
        sd = np.asarray([0.0, 0.7071, 0.7071])
    alb_sky = p.get("albedo", 0.2)
    kw = dict(sun_dir=np.asarray(sd, np.float64), turbidity=float(p.get("turbidity", 3.0)),
              scale=float(p.get("scale", 1.0)), resolution=int(p.get("resolution", 512)),
              sun_radius_scale=float(p.get("sunRadiusScale", 1.0)))
    # the reference evaluates Hosek-Wilkie (sky.cpp:246); skyModel="preetham"
    # selects the legacy dome
    sky_model = str(p.get("skyModel", "hosek"))
    data = sunskylib.bake(
        typ, sky_model=sky_model,
        albedo=(np.asarray(alb_sky, np.float64) if not np.isscalar(alb_sky)
                else float(alb_sky)), **kw)
    ld.env_radiance = None
    ld.cfg_kw.setdefault("_envmap", data)
    if sky_model == "hosek":
        # true-spectral companion stack for the spectral renderer (the
        # reference's SPECTRUM_SAMPLES>3 build)
        ld.cfg_kw.setdefault("_envmap_spectral", sunskylib.bake_spectral(
            typ, albedo=float(np.mean(alb_sky)), **kw))


def _finish(ld):
    envmap = ld.cfg_kw.pop("_envmap", None)
    envmap_spectral = ld.cfg_kw.pop("_envmap_spectral", None)
    if not ld.tris:
        # shapeless scenes are legal (e.g. a radiancemeter watching a
        # collimated emitter, data/tests/test_bidir_1.xml); the IR needs
        # one triangle, so park a degenerate black one far away
        ld.materials.append({"type": ir.BSDF_DIFFUSE,
                             "reflectance": [0.0, 0.0, 0.0]})
        ld.add_mesh(np.asarray([[1e8, 1e8, 1e8], [1e8 + 1e-3, 1e8, 1e8],
                                [1e8, 1e8 + 1e-3, 1e8]], np.float32),
                    np.asarray([[0, 1, 2]], np.int32),
                    len(ld.materials) - 1)
    normals = np.asarray(ld.normals, np.float32)
    if ld.curvature_req is not None:
        ld.vert_colors = _bake_curvature(
            np.asarray(ld.verts, np.float32), np.asarray(ld.tris, np.int32),
            *ld.curvature_req)
        ld.any_vert_colors = True
    scene = ir.build_scene(
        np.asarray(ld.verts, np.float32),
        np.asarray(ld.tris, np.int32),
        np.asarray(ld.tri_mat, np.int32),
        ld.materials,
        tri_radiance=ld.tri_rad,
        normals=normals if np.abs(normals).sum() > 0 else None,
        uvs=np.asarray(ld.uvs, np.float32),
        env_radiance=ld.env_radiance,
        textures=ld.textures or None,
        vertex_colors=(np.asarray(ld.vert_colors, np.float32)
                       if ld.any_vert_colors else None),
        wire_params=ld.wire_params,
        lod_scale=_lod_scale(ld),
        device=ld.device,
    )
    if envmap is not None:
        from . import envmap as envlib
        scene = envlib.attach_envmap(scene, envmap, spectral=envmap_spectral)
    if ld.delta_emitters:
        scene = scene.replace(
            delta_emitters=ir.build_delta_emitters(ld.delta_emitters,
                                                   device=ld.device)
        )
    if ld.medium is not None:
        scene = scene.replace(medium=ld.medium)
    if ld.cloth_entries:
        from ..models import cloth as clothlib
        scene = scene.replace(cloth=clothlib.build_tables(
            ld.cloth_entries, len(ld.materials), ld.cloth_slots, device=ld.device))
    # power-weighted (area, env, delta) emitter-group selection
    # (scene.cpp:131 m_emitterPDF analog; uniform split otherwise)
    from ..models import emitter as emitterlib
    scene = emitterlib.compute_group_probs(scene)
    cfg = integ_common.RenderConfig(**ld.cfg_kw)
    if ld.cam is None:
        ld.cam = sensorlib.make_camera([0, 0, -3], [0, 0, 0], width=ld.width,
                                       height=ld.height, device=ld.device)
    return scene, ld.cam, cfg, ld.integrator


def _bake_curvature(verts, tris, kind="gaussian", scale=1.0):
    """Per-vertex curvature -> diverging red/blue colors
    (src/textures/curvature.cpp visualization). Gaussian curvature by the
    angle-deficit formula; "mean" approximated by |deficit| magnitude."""
    V = len(verts)
    p0 = verts[tris[:, 0]]
    p1 = verts[tris[:, 1]]
    p2 = verts[tris[:, 2]]

    def angle(a, b):
        an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        return np.arccos(np.clip(np.sum(an * bn, 1), -1.0, 1.0))

    a0 = angle(p1 - p0, p2 - p0)
    a1 = angle(p0 - p1, p2 - p1)
    a2 = angle(p0 - p2, p1 - p2)
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
    ang_sum = np.zeros(V)
    varea = np.zeros(V)
    for k, ak in enumerate((a0, a1, a2)):
        np.add.at(ang_sum, tris[:, k], ak)
        np.add.at(varea, tris[:, k], area / 3.0)
    kappa = (2.0 * np.pi - ang_sum) / np.maximum(varea, 1e-12)
    if kind == "mean":
        kappa = np.abs(kappa)
    x = np.tanh(kappa * scale * 1e-3)
    colors = np.stack([0.5 + 0.5 * np.maximum(x, 0),
                       np.full(V, 0.5) - 0.25 * np.abs(x),
                       0.5 + 0.5 * np.maximum(-x, 0)], -1)
    return colors.astype(np.float32)


def _lod_scale(ld):
    """World-space width of one pixel at unit distance (the camera factor
    of the mip footprint; mipmap.h trilinear LOD). None disables mips."""
    if not ld.textures or ld.cam is None:
        return None
    fov = float(ld.cam.fov_x)
    return 2.0 * float(np.tan(np.deg2rad(fov) / 2.0)) / max(ld.width, 1)
