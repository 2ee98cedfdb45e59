"""Flattened scene IR: triangle soup + SoA material/emitter tables (port
of scene/ir.py).

The scene is a dataclass of tensors. The static fields (`num_triangles`,
`bsdf_families`, `has_env`, `has_area`, `has_null`, `group_probs`) stay
plain Python, as they are static pytree fields in the JAX package. Textures,
mip levels, vertex colours and wireframe materials are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# BSDF type codes (same values as the JAX package)
BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_DIELECTRIC = 4
BSDF_ROUGH_DIELECTRIC = 5
BSDF_PLASTIC = 6
BSDF_ROUGH_PLASTIC = 7
BSDF_PHONG = 8
BSDF_THIN_DIELECTRIC = 9
BSDF_ROUGH_DIFFUSE = 10
BSDF_WARD = 11
BSDF_MASK = 12
BSDF_TWO_SIDED = 13
BSDF_BLEND = 14
BSDF_DIFFUSE_TRANSMITTER = 15
BSDF_COATING = 16
BSDF_HK = 17
BSDF_IRAWAN = 18

BSDF_NAMES = {v: k[5:].lower() for k, v in list(globals().items())
              if k.startswith("BSDF_")}

TEX_NONE = -1


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Materials(_Replace):
    """SoA BSDF table; see the JAX package's Materials for the layout."""

    type: torch.Tensor             # (M,) int32 BSDF_* code
    reflectance: torch.Tensor      # (M,3)
    specular: torch.Tensor         # (M,3)
    eta: torch.Tensor              # (M,3)
    k: torch.Tensor                # (M,3)
    alpha: torch.Tensor            # (M,2)
    extra: torch.Tensor            # (M,4)
    tex_reflectance: torch.Tensor  # (M,) int32
    nested: torch.Tensor           # (M,2) int32
    tex_perturb: torch.Tensor      # (M,) int32
    perturb_kind: torch.Tensor     # (M,) int32

    @staticmethod
    def stack(records: list[dict], device) -> "Materials":
        n = max(len(records), 1)

        def col(key, width, default):
            out = np.tile(np.asarray(default, np.float32), (n, 1))
            for i, r in enumerate(records):
                if key in r:
                    out[i] = np.broadcast_to(np.asarray(r[key], np.float32), (width,))
            return torch.as_tensor(out, device=device)

        types = np.full((n,), BSDF_DIFFUSE, np.int32)
        texr = np.full((n,), TEX_NONE, np.int32)
        nested = np.full((n, 2), -1, np.int32)
        texp = np.full((n,), TEX_NONE, np.int32)
        pkind = np.zeros((n,), np.int32)
        for i, r in enumerate(records):
            types[i] = r.get("type", BSDF_DIFFUSE)
            texr[i] = r.get("tex_reflectance", TEX_NONE)
            nested[i] = r.get("nested", (-1, -1))
            texp[i] = r.get("tex_perturb", TEX_NONE)
            pkind[i] = r.get("perturb_kind", 0)

        def t(a):
            return torch.as_tensor(a, device=device)

        return Materials(
            type=t(types),
            reflectance=col("reflectance", 3, [0.5, 0.5, 0.5]),
            specular=col("specular", 3, [1.0, 1.0, 1.0]),
            eta=col("eta", 3, [1.5, 1.5, 1.5]),
            k=col("k", 3, [0.0, 0.0, 0.0]),
            alpha=col("alpha", 2, [0.1, 0.1]),
            extra=col("extra", 4, [0.0, 0.0, 0.0, 0.0]),
            tex_reflectance=t(texr),
            nested=t(nested),
            tex_perturb=t(texp),
            perturb_kind=t(pkind),
        )


@dataclasses.dataclass
class AreaEmitters(_Replace):
    """Area emitter table + triangle sampling distribution."""

    radiance: torch.Tensor         # (E,3)
    tri_index: torch.Tensor        # (ET,) int32
    tri_emitter: torch.Tensor      # (ET,) int32
    tri_cdf: torch.Tensor          # (ET,) inclusive CDF
    tri_pdf: torch.Tensor          # (ET,)
    select_pdf_full: torch.Tensor  # (T,) selection prob per scene triangle


@dataclasses.dataclass
class Scene(_Replace):
    """The whole flattened scene."""

    vertices: torch.Tensor      # (V,3)
    indices: torch.Tensor       # (T,3) int32
    normals: torch.Tensor       # (V,3) shading normals
    uvs: torch.Tensor           # (V,2)
    tri_material: torch.Tensor  # (T,) int32
    tri_emitter: torch.Tensor   # (T,) int32, -1 if not emissive
    tri_opaque: torch.Tensor    # (T,) bool: False for null-BSDF triangles
    materials: Materials
    emitters: AreaEmitters
    env_radiance: torch.Tensor  # (3,) constant environment
    # texture stack; (1,1,1,3) zeros = no textures (the only case ported)
    textures: torch.Tensor

    # static metadata
    group_probs: tuple = ()
    num_triangles: int = 0
    bsdf_families: tuple = ()
    has_env: bool = False
    has_area: bool = True
    has_null: bool = False

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def tri_vertices(self):
        """Returns (p0, e1, e2): (T,3) base vertex and edge vectors."""
        v = self.vertices
        i = self.indices
        p0 = v[i[:, 0]]
        e1 = v[i[:, 1]] - p0
        e2 = v[i[:, 2]] - p0
        return p0, e1, e2


def build_scene(
    vertices: np.ndarray,
    indices: np.ndarray,
    tri_material: np.ndarray,
    materials: list[dict],
    tri_radiance: Optional[dict] = None,
    normals: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    env_radiance=None,
    textures: Optional[list] = None,
    vertex_colors: Optional[np.ndarray] = None,
    wire_params=None,
    lod_scale: Optional[float] = None,
    device="cpu",
) -> Scene:
    """Host-side scene assembly in numpy, then one copy to `device`."""
    unported = {"textures": textures or None, "vertex_colors": vertex_colors,
                "wire_params": wire_params, "lod_scale": lod_scale}
    for name, val in unported.items():
        if val is not None:
            raise NotImplementedError(f"build_scene: {name} is not ported")
    if any(int(r.get("perturb_kind", 0)) != 0 for r in materials):
        raise NotImplementedError("build_scene: normal/bump maps are not ported")

    def t(a):
        return torch.as_tensor(a, device=device)

    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    T = indices.shape[0]
    tri_material = np.asarray(tri_material, np.int32)

    if normals is None:
        # area-weighted vertex normals
        p0 = vertices[indices[:, 0]]
        fn = np.cross(vertices[indices[:, 1]] - p0, vertices[indices[:, 2]] - p0)
        normals = np.zeros_like(vertices)
        for k in range(3):
            np.add.at(normals, indices[:, k], fn)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(lens, 1e-20)
    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), np.float32)

    tri_emitter = np.full((T,), -1, np.int32)
    em_radiance, em_tris, em_emitter = [], [], []
    if tri_radiance:
        # group contiguous identical radiances into one emitter each
        rad_key = {}
        for tri, rad in sorted(tri_radiance.items()):
            key = tuple(np.asarray(rad, np.float32).reshape(3))
            if key not in rad_key:
                rad_key[key] = len(em_radiance)
                em_radiance.append(np.asarray(key, np.float32))
            e = rad_key[key]
            tri_emitter[tri] = e
            em_tris.append(tri)
            em_emitter.append(e)

    if em_tris:
        em_tris_np = np.asarray(em_tris, np.int32)
        em_emitter_np = np.asarray(em_emitter, np.int32)
        em_rad_np = np.stack(em_radiance)
        p0 = vertices[indices[em_tris_np, 0]]
        e1 = vertices[indices[em_tris_np, 1]] - p0
        e2 = vertices[indices[em_tris_np, 2]] - p0
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        # weight by area x luminance
        lum = em_rad_np[em_emitter_np] @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        w = areas * np.maximum(lum, 1e-12)
        pdf = w / w.sum()
        cdf = np.cumsum(pdf).astype(np.float32)
        cdf[-1] = 1.0
        select_full = np.zeros((T,), np.float32)
        select_full[em_tris_np] = pdf
        emitters = AreaEmitters(
            radiance=t(em_rad_np),
            tri_index=t(em_tris_np),
            tri_emitter=t(em_emitter_np),
            tri_cdf=t(cdf),
            tri_pdf=t(pdf.astype(np.float32)),
            select_pdf_full=t(select_full),
        )
    else:
        emitters = AreaEmitters(
            radiance=t(np.zeros((1, 3), np.float32)),
            tri_index=t(np.zeros((1,), np.int32)),
            tri_emitter=t(np.zeros((1,), np.int32)),
            tri_cdf=t(np.ones((1,), np.float32)),
            tri_pdf=t(np.ones((1,), np.float32)),
            select_pdf_full=t(np.zeros((T,), np.float32)),
        )

    families = tuple(sorted({int(r.get("type", BSDF_DIFFUSE)) for r in materials}))
    has_env = env_radiance is not None
    env = np.asarray(env_radiance if has_env else [0.0, 0.0, 0.0], np.float32)

    mat_types = np.asarray(
        [int(r.get("type", BSDF_DIFFUSE)) for r in materials] or [BSDF_DIFFUSE],
        np.int32)
    tri_opaque = mat_types[np.clip(tri_material, 0, len(mat_types) - 1)] \
        != BSDF_NULL

    return Scene(
        vertices=t(vertices),
        indices=t(indices),
        normals=t(normals.astype(np.float32)),
        uvs=t(uvs.astype(np.float32)),
        tri_material=t(tri_material),
        tri_emitter=t(tri_emitter),
        tri_opaque=t(tri_opaque),
        materials=Materials.stack(materials, device),
        emitters=emitters,
        env_radiance=t(env),
        textures=t(np.zeros((1, 1, 1, 3), np.float32)),
        num_triangles=int(T),
        bsdf_families=families,
        has_env=bool(has_env),
        has_area=bool(em_tris),
        has_null=bool((~tri_opaque).any()),
    )


# JAX scene fields the port has no counterpart for yet; a scene that sets
# one of them cannot be carried across.
_UNPORTED = ("tex_mips", "tri_uv_density", "bvh", "clusters", "envmap",
             "medium", "cloth", "delta_emitters", "occupancy",
             "vertex_colors", "wire_params")


def _leaf(x, device):
    # np.array copies: the leaves of a jax array are read-only buffers
    return torch.as_tensor(np.array(x), device=device)


def _tensor_fields(cls, src, device):
    return {f.name: _leaf(getattr(src, f.name), device)
            for f in dataclasses.fields(cls)}


def from_jax(jscene, device="cpu") -> Scene:
    """Carry a JAX package Scene across: each leaf goes through
    `np.array` (so `jscene` may hold jax or numpy arrays) and the static
    fields are copied. Raises for the parts of the JAX IR the port does not
    have yet."""
    for name in _UNPORTED:
        if getattr(jscene, name, None) is not None:
            raise NotImplementedError(f"from_jax: scene.{name} is not ported")
    if getattr(jscene, "has_perturb", False):
        raise NotImplementedError("from_jax: normal/bump maps are not ported")
    fields = {}
    for f in dataclasses.fields(Scene):
        if f.name == "materials":
            fields[f.name] = Materials(**_tensor_fields(Materials, jscene.materials, device))
        elif f.name == "emitters":
            fields[f.name] = AreaEmitters(**_tensor_fields(AreaEmitters, jscene.emitters, device))
        elif f.type in ("tuple", "int", "bool"):
            fields[f.name] = getattr(jscene, f.name)
        else:
            fields[f.name] = _leaf(getattr(jscene, f.name), device)
    fields["group_probs"] = tuple(float(p) for p in fields["group_probs"])
    fields["bsdf_families"] = tuple(int(b) for b in fields["bsdf_families"])
    return Scene(**fields)
