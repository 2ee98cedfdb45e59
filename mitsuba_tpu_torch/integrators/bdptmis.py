"""Recursive MIS bookkeeping for the bidirectional integrators, BDPT and
LVC-BPT (port of integrators/bdptmis.py).

Instead of re-walking each path's cached per-vertex pdfs per connection
(libbidir's Path::miWeight), every subpath carries the two streaming
quantities of "Implementing Vertex Connection and Merging" (Georgiev
2012), dvcm and dvc, merging terms dropped:

  after scattering with forward solid-angle pdf p_fwd, reverse pdf p_rev
  and outgoing cosine c:
      dvc  <- (c / p_fwd)^b (dvc p_rev^b + dvcm)
      dvcm <- (1 / p_fwd)^b
  on arriving across distance d with incident cosine c_in:
      dvcm <- dvcm d^(2b) / |c_in|^b,   dvc <- dvc / |c_in|^b

b is the MIS exponent (1: balance, 2: power; the fork's m_MISmode). Each
weight below then needs only the reverse pdfs at the junction. A delta
lobe zeroes dvcm and carries dvc through with the cosine only. Russian
roulette stays out of every pdf, as in the reference's libbidir.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..models.emitter import EV_AREA, EV_ENV, emitter_dir_pdf_area, emitter_hit_pdf


class MisState(NamedTuple):
    dvcm: torch.Tensor   # (N,)
    dvc: torch.Tensor    # (N,)


def _mis(x, b):
    if b == 1.0:
        return x
    if b == 2.0:
        return x * x
    return x ** b


def light_start(ers, b) -> MisState:
    """The state after sampling the emitter ray, before its first hit:
    dvcm = (1/pdf_dir)^b; dvc carries the s=0 (eye hits the light)
    strategy of the lights a walk can hit (area, env), with the emission
    cosine of an area light (1 for the environment)."""
    dvcm = _mis(m.safe_div(1.0, ers.pdf_dir), b)
    cos0 = torch.where(ers.kind == EV_AREA, torch.clamp_min(m.dot(ers.d, ers.ng), 0.0), 1.0)
    can_hit = (ers.kind == EV_AREA) | (ers.kind == EV_ENV)
    dvc = torch.where(can_hit, _mis(m.safe_div(cos0, ers.pdf_pos * ers.pdf_dir), b), 0.0)
    return MisState(dvcm=dvcm, dvc=dvc)


def camera_start(n_light_paths, pdf_cam_sa, b, light_image: bool) -> MisState:
    """The camera subpath's state. dvcm holds the t=1 (light image)
    strategy, n_light_paths light subpaths against the pixel's one eye
    path; without a light image that strategy does not exist (0)."""
    zeros = torch.zeros_like(pdf_cam_sa)
    if not light_image:
        return MisState(dvcm=zeros, dvc=zeros)
    return MisState(dvcm=_mis(m.safe_div(float(n_light_paths), pdf_cam_sa), b), dvc=zeros)


def on_hit(st: MisState, dist2, cos_in, b, skip_dist2=None) -> MisState:
    """Arriving at a surface across dist2 with incident cosine cos_in;
    skip_dist2 marks lanes whose previous vertex is an infinite light
    (parallel rays: no 1/d^2)."""
    scale = _mis(dist2, b)
    if skip_dist2 is not None:
        scale = torch.where(skip_dist2, 1.0, scale)
    c = _mis(torch.clamp_min(torch.abs(cos_in), 1e-8), b)
    return MisState(dvcm=st.dvcm * scale / c, dvc=st.dvc / c)


def scatter(st: MisState, pdf_fwd_sa, pdf_rev_sa, cos_out, is_delta, b) -> MisState:
    """Continuing the walk through a sampled lobe."""
    c = _mis(torch.abs(cos_out), b)
    pf = _mis(m.safe_div(1.0, torch.clamp_min(pdf_fwd_sa, 1e-20)), b)
    dvc_s = st.dvc * c                      # specular chain
    dvc_ns = c * pf * (st.dvc * _mis(pdf_rev_sa, b) + st.dvcm)
    return MisState(dvcm=torch.where(is_delta, 0.0, pf),
                    dvc=torch.where(is_delta, dvc_s, dvc_ns))


# ---------------------------------------------------------------------------
# Per-strategy weights. Every BSDF pdf is in solid angle; the measure
# conversions live in dvcm/dvc and the emitter pdf helpers.
# ---------------------------------------------------------------------------

def weight_hit_area(st: MisState, direct_pdf_a, emission_pdf, b):
    """The eye path hits an area emitter (s=0). direct_pdf_a: the NEE area
    pdf of the hit point with its pick probability; emission_pdf:
    pdf_pos pdf_dir of emitting the arriving ray."""
    w_cam = _mis(direct_pdf_a, b) * st.dvcm + _mis(emission_pdf, b) * st.dvc
    return 1.0 / (1.0 + w_cam)


def weight_hit_env(st_pre: MisState, direct_pdf_sa, disk_pdf, b):
    """The eye path escapes to the environment; the state before the
    on-hit update (the env vertex's measure is solid angle)."""
    w_cam = (_mis(direct_pdf_sa, b) * st_pre.dvcm
             + _mis(direct_pdf_sa * disk_pdf, b) * st_pre.dvc)
    return 1.0 / (1.0 + w_cam)


def weight_connect_z0(st_y: MisState, ers_kind, z0_pos, z0_ng, z0_aux, z0_cut, z0_pdf_pos,
                      disk_pdf, y_p, y_ng, pdf_y_sa, pdf_y_rev_sa, b):
    """The eye vertex y connects to the light-path origin z0 (s=1, NEE).
    pdf_y_sa: y scatters toward z0; pdf_y_rev_sa: y scatters back toward
    its predecessor, arriving from z0."""
    # s=0: the eye walk hits z0 instead (0 for delta lights)
    p_hit = emitter_hit_pdf(ers_kind, z0_pos, z0_ng, y_p, pdf_y_sa)
    w_light = _mis(m.safe_div(p_hit, torch.clamp_min(z0_pdf_pos, 1e-20)), b)
    # s>=2: the light walk continues past z0 to y and beyond
    p_emit_area = emitter_dir_pdf_area(ers_kind, z0_pos, z0_ng, z0_aux, z0_cut, disk_pdf,
                                       y_p, y_ng)
    w_cam = _mis(p_emit_area, b) * (st_y.dvcm + st_y.dvc * _mis(pdf_y_rev_sa, b))
    return 1.0 / (w_light + 1.0 + w_cam)


def weight_connect_inner(st_y: MisState, st_z: MisState, pdf_y_sa, pdf_y_rev_sa, pdf_z_sa,
                         pdf_z_rev_sa, cos_y, cos_z, d2, b):
    """The inner connection y_t <-> z_s (s>=2, t>=2). pdf_y_sa: y scatters
    toward z; pdf_z_sa: z toward y; *_rev_sa: each toward its own
    predecessor, arriving along the connection. cos_y, cos_z: |n . the
    connection| at each end."""
    pdf_y_to_z_area = pdf_y_sa * torch.abs(cos_z) / torch.clamp_min(d2, 1e-12)
    pdf_z_to_y_area = pdf_z_sa * torch.abs(cos_y) / torch.clamp_min(d2, 1e-12)
    w_light = _mis(pdf_y_to_z_area, b) * (st_z.dvcm + st_z.dvc * _mis(pdf_z_rev_sa, b))
    w_cam = _mis(pdf_z_to_y_area, b) * (st_y.dvcm + st_y.dvc * _mis(pdf_y_rev_sa, b))
    return 1.0 / (w_light + 1.0 + w_cam)


def weight_splat(st_z: MisState, pdf_cam_area, n_light_paths, pdf_z_rev_sa, b):
    """The light vertex z splats to the camera (t=1). pdf_cam_area: the
    camera's importance pdf at z in area measure; pdf_z_rev_sa: z scatters
    toward its predecessor, arriving from the camera."""
    w_light = _mis(pdf_cam_area / float(n_light_paths), b) * (
        st_z.dvcm + st_z.dvc * _mis(pdf_z_rev_sa, b))
    return 1.0 / (w_light + 1.0)


def weight_splat_z0(z0_pdf_pos, pdf_cam_area, n_light_paths, is_area, b):
    """(s=1, t=1): the emitter vertex itself splats to the camera (a light
    seen directly); the one competing strategy is the eye ray hitting it."""
    r = m.safe_div(pdf_cam_area, float(n_light_paths) * torch.clamp_min(z0_pdf_pos, 1e-20))
    return torch.where(is_area, 1.0 / (1.0 + _mis(r, b)), 0.0)
