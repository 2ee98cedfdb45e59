"""The port's scene loader (mitsuba_tpu_torch/scene/xml.py) against the JAX
package's: the same XML files (written here, as tests/test_loaders.py's
fixtures are) load through both packages, and the port's Scene is held
field by field against `ir.from_jax` of the JAX scene, its camera against
`camera_from_jax`, its config against `config_from_jax`, and the
integrator names for equality. Integer, boolean and static fields and the
fields copied from the file (vertices, indices, uvs, textures, materials)
are held bit for bit; every other float field at C10's bar (atol 1e-6 +
rtol 1e-6). Also: the unused-property list kept per load (C34), the
sun, sky and sunsky emitters and the Irawan cloth BSDF (their envmap and
band stack at C10's bar, the cloth tables bit for bit but the spec_norm
column of `patp`, within 1e-6), and the loaded Cornell scene rendered
through both packages at the goldens' 1e-4."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import common as j_common, path as j_path
from mitsuba_tpu.io import image as j_image, vol as j_vol
from mitsuba_tpu.scene import xml as j_xml
from mitsuba_tpu_torch.integrators import common, path
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import ir, xml

torch.set_num_threads(1)

C10_ATOL = C10_RTOL = 1e-6
RENDER_TOL = 1e-4
# fields read from the file or copied from a property: bit for bit
COPIED = ("vertices", "indices", "uvs", "textures", "tex_size", "tex_transform",
          "tex_nearest", "materials", "env_radiance", "vertex_colors", "wire_params",
          "repeat", "yarn")


def _compare(mine, ref, where="scene", exact=False, diffs=None):
    """Walk two port objects (dataclasses, tensors, static values) and
    assert them equal: exact for integer/bool tensors, static fields and
    `exact` subtrees, else within C10's bar. Returns {field: max abs
    float difference}."""
    diffs = {} if diffs is None else diffs
    if dataclasses.is_dataclass(ref):
        assert type(mine) is type(ref), where
        for f in dataclasses.fields(ref):
            _compare(getattr(mine, f.name), getattr(ref, f.name), f"{where}.{f.name}",
                     exact or f.name in COPIED, diffs)
    elif isinstance(ref, tuple) and hasattr(ref, "_fields"):
        # a NamedTuple of tensors (the cloth tables)
        assert type(mine) is type(ref), where
        for name in ref._fields:
            _compare(getattr(mine, name), getattr(ref, name), f"{where}.{name}",
                     exact or name in COPIED, diffs)
    elif isinstance(ref, torch.Tensor):
        assert isinstance(mine, torch.Tensor), where
        assert mine.shape == ref.shape and mine.dtype == ref.dtype, \
            (where, mine.shape, ref.shape, mine.dtype, ref.dtype)
        if exact or not ref.is_floating_point():
            assert torch.equal(mine, ref), where
        else:
            torch.testing.assert_close(mine, ref, atol=C10_ATOL, rtol=C10_RTOL, msg=where)
        if ref.is_floating_point() and ref.numel():
            diffs[where] = float((mine.double() - ref.double()).abs().max())
    elif isinstance(ref, float) and not exact:
        assert mine == pytest.approx(ref, rel=C10_RTOL, abs=C10_ATOL), where
        diffs[where] = abs(mine - ref)
    elif isinstance(ref, tuple) and ref and isinstance(ref[0], float):
        assert len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            _compare(a, b, f"{where}[{i}]", exact, diffs)
    else:
        assert mine == ref, (where, mine, ref)
    return diffs


def load_both(p, **kw):
    """Load `p` through both packages and hold the port's result against
    the JAX one carried across. Returns the port's result. Measured on the
    CPU: every float field equal but the blackbody radiance (8.3e-7 of
    1.70: Planck in float32 through XLA's exp and torch's) and the group
    probabilities that follow it (4.4e-10)."""
    jscene, jcam, jcfg, jname = j_xml.load_xml(p, **kw)
    scene, cam, cfg, name = xml.load_xml(p, device="cpu", **kw)
    assert name == jname
    assert cfg == common.config_from_jax(jcfg)
    _compare(scene, ir.from_jax(jscene, "cpu"))
    _compare(cam, sensor.camera_from_jax(jcam, "cpu"), "camera")
    return scene, cam, cfg, name


def _film(w=8, h=8, extra=""):
    return (f'<film type="hdrfilm"><integer name="width" value="{w}"/>'
            f'<integer name="height" value="{h}"/>{extra}</film>')


def _sensor(body="", film=None, kind="perspective"):
    return f'<sensor type="{kind}">{body}{film or _film()}</sensor>'


CORNELL_XML = f"""\
<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="4"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
            <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="ldsampler">
            <integer name="sampleCount" value="4"/>
        </sampler>
        {_film()}
    </sensor>
    <bsdf type="diffuse" id="white">
        <rgb name="reflectance" value="0.7, 0.7, 0.7"/>
    </bsdf>
    <shape type="rectangle">
        <transform name="toWorld">
            <rotate x="1" angle="-90"/>
            <scale value="2"/>
        </transform>
        <ref id="white"/>
    </shape>
    <shape type="sphere">
        <point name="center" x="0" y="0.5" z="0"/>
        <float name="radius" value="0.5"/>
        <bsdf type="roughconductor">
            <float name="alpha" value="0.2"/>
            <string name="distribution" value="ggx"/>
        </bsdf>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <rotate x="1" angle="90"/>
            <translate y="3"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="10, 10, 10"/>
        </emitter>
    </shape>
</scene>
"""


def _scene(body, integrator="path", sensor_xml=None):
    return (f'<scene version="0.6.0"><integrator type="{integrator}"/>'
            f'{sensor_xml or _sensor()}{body}</scene>')


def _ply_colors(path):
    path.write_text("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
                    "property float y\nproperty float z\nproperty uchar red\n"
                    "property uchar green\nproperty uchar blue\nelement face 2\n"
                    "property list uchar int vertex_indices\nend_header\n"
                    "-1 0 -1 255 0 0\n1 0 -1 0 255 0\n1 0 1 0 0 255\n"
                    "-1 0 1 255 255 0\n3 0 2 1\n3 0 3 2\n")


def _write(d, name, text):
    (d / name).write_text(text)
    return d / name


# Each case writes its files into a directory and returns (the scene file,
# load_xml keywords).
def case_cornell(d):
    return _write(d, "s.xml", CORNELL_XML), {}


def case_defaults(d):
    text = ('<scene version="0.6.0"><default name="res" value="12"/>'
            '<default name="refl" value="0.2"/><integrator type="direct"/>'
            '<sensor type="perspective"><film type="hdrfilm">'
            '<integer name="width" value="$res"/><integer name="height" value="$res"/>'
            '</film></sensor><shape type="cube"><bsdf type="diffuse">'
            '<rgb name="reflectance" value="$refl"/></bsdf></shape></scene>')
    return _write(d, "s.xml", text), {"defaults": {"res": "8", "refl": "0.4, 0.5, 0.6"}}


def case_envmap(d):
    env = np.zeros((8, 16, 3), np.float32)
    env[2, 5] = [50.0, 25.0, 10.0]
    env[6, 1] = [1.0, 2.0, 3.0]
    j_image.write_exr(d / "env.exr", env)
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"/><emitter type="envmap"><string name="filename" '
        'value="env.exr"/><float name="scale" value="2"/><transform name="toWorld">'
        '<rotate y="1" angle="30"/></transform></emitter>')), {}


def case_homogeneous_medium(d):
    return _write(d, "s.xml", _scene(
        '<medium type="homogeneous"><rgb name="sigmaS" value="0.5, 0.6, 0.7"/>'
        '<rgb name="sigmaA" value="0.1, 0.1, 0.1"/><phase type="hg">'
        '<float name="g" value="0.3"/></phase></medium><shape type="cube"/>',
        integrator="volpath")), {}


def case_vol_medium_interior_ref(d):
    dens = np.random.RandomState(5).uniform(0, 1, (8, 8, 8)).astype(np.float32)
    j_vol.write_vol(d / "smoke.vol", dens, (0, 0, 0), (1, 1, 1))
    return _write(d, "s.xml", _scene(
        '<medium type="heterogeneous" id="smoke"><volume name="density" '
        'type="gridvolume"><string name="filename" value="smoke.vol"/></volume>'
        '<float name="scale" value="4.0"/><rgb name="albedo" value="0.9, 0.9, 0.9"/>'
        '<phase type="rayleigh"/></medium>'
        '<shape type="cube"><ref name="interior" id="smoke"/></shape>',
        integrator="volpath")), {}


def case_voxelized_interior(d):
    return _write(d, "s.xml", _scene(
        '<shape type="sphere"><float name="radius" value="0.8"/>'
        '<medium name="interior" type="homogeneous"><rgb name="sigmaS" value="2, 2, 2"/>'
        '<rgb name="sigmaA" value="0.5, 0.5, 0.5"/></medium></shape>'
        '<shape type="rectangle"/>', integrator="volpath")), {}


def case_include(d):
    _write(d, "frag.xml", '<scene version="0.6.0"><default name="refl" '
           'value="0.25, 0.5, 0.75"/><bsdf type="diffuse" id="incmat"><rgb '
           'name="reflectance" value="$refl"/></bsdf><shape type="rectangle">'
           '<ref id="incmat"/></shape></scene>')
    return _write(d, "s.xml", _scene('<include filename="frag.xml"/><shape type="cube"/>')), {}


def case_opacity_masks(d):
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"><bsdf type="mask"><float name="opacity" value="0.3"/>'
        '<bsdf type="diffuse"/></bsdf></shape>'
        '<shape type="cube"><bsdf type="mask"><texture name="opacity" '
        'type="checkerboard"><rgb name="color0" value="0, 0, 0"/><rgb name="color1" '
        'value="1, 1, 1"/><float name="uscale" value="4"/><float name="vscale" '
        'value="4"/></texture><bsdf type="diffuse"><rgb name="reflectance" '
        'value="0, 0, 0"/></bsdf></bsdf></shape>'
        '<emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>')), {}


FILTERS = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")


def case_rfilter(d):
    for f in FILTERS:
        _write(d, f"{f}.xml", _scene('<shape type="cube"/>', sensor_xml=_sensor(
            film=_film(extra=f'<rfilter type="{f}"/>'))))
    return d / "box.xml", {}


def case_vertex_colors(d):
    _ply_colors(d / "c.ply")
    return _write(d, "s.xml", _scene(
        '<shape type="ply"><string name="filename" value="c.ply"/><bsdf type="diffuse">'
        '<texture name="reflectance" type="vertexcolors"/></bsdf></shape>'
        '<emitter type="constant"><rgb name="radiance" value="2,2,2"/></emitter>',
        integrator="direct")), {}


def case_wireframe_scale_grid(d):
    j_image.write_exr(d / "t.exr", np.full((4, 4, 3), 0.5, np.float32))
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"><bsdf type="diffuse"><texture name="reflectance" '
        'type="wireframe"><rgb name="interiorColor" value="0.6, 0.6, 0.6"/>'
        '<rgb name="edgeColor" value="0.0, 0.0, 0.0"/></texture></bsdf></shape>'
        '<shape type="cube"><bsdf type="diffuse"><texture name="reflectance" '
        'type="scale"><float name="scale" value="0.5"/><texture name="nested" '
        'type="bitmap"><string name="filename" value="t.exr"/></texture></texture>'
        '</bsdf></shape><shape type="disk"><bsdf type="diffuse"><texture '
        'name="reflectance" type="gridtexture"><rgb name="color0" value="0.8, 0.8, 0.8"/>'
        '<rgb name="color1" value="0.1, 0.1, 0.1"/></texture></bsdf></shape>',
        integrator="direct")), {}


def case_curvature(d):
    return _write(d, "s.xml", _scene(
        '<shape type="sphere"><bsdf type="diffuse"><texture name="reflectance" '
        'type="curvature"><string name="curvature" value="mean"/><float name="scale" '
        'value="2.0"/></texture></bsdf></shape>', integrator="direct")), {}


def case_mip_textures(d):
    t = np.indices((64, 64)).sum(0) % 2
    j_image.write_exr(d / "c.exr", np.repeat(t[..., None], 3, -1).astype(np.float32))
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"><bsdf type="diffuse"><texture name="reflectance" '
        'type="bitmap"><string name="filename" value="c.exr"/><float name="uscale" '
        'value="32"/><float name="vscale" value="32"/></texture></bsdf></shape>'
        '<emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>',
        integrator="direct", sensor_xml=_sensor(
            '<float name="fov" value="2.5"/><transform name="toWorld"><lookat '
            'origin="0, 0.01, 40" target="0, 0, 0" up="0, 1, 0"/></transform>'))), {}


def case_hair(d):
    (d / "h.hair").write_text("0 0 0\n0 1 0\n0 2 0\n#\n1 0 0\n1 1 0.2\n")
    return _write(d, "s.xml", _scene(
        '<shape type="hair"><string name="filename" value="h.hair"/>'
        '<float name="radius" value="0.1"/></shape>'
        '<emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>',
        integrator="direct")), {}


def case_named_ior_and_flip(d):
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"><boolean name="flipNormals" value="true"/>'
        '<bsdf type="dielectric"><string name="intIOR" value="diamond"/>'
        '<string name="extIOR" value="water"/></bsdf></shape>'
        '<shape type="rectangle"><bsdf type="roughplastic"><string name="intIOR" '
        'value="bk7"/><float name="alpha" value="0.3"/></bsdf></shape>')), {}


def case_search_paths(d):
    (d / "textures").mkdir()
    j_image.write_png(str(d / "textures" / "tex.png"), np.full((4, 4, 3), 0.5, np.float32))
    return _write(d, "s.xml", _scene(
        '<shape type="rectangle"><bsdf type="diffuse"><texture name="reflectance" '
        'type="bitmap"><string name="filename" value="tex.png"/></texture></bsdf>'
        '</shape>')), {"search_paths": [str(d / "textures")]}


def case_legacy_0_3(d):
    return _write(d, "old.xml", """\
<scene version="0.3.0">
    <integrator type="direct"><integer name="luminaireSamples" value="2"/></integrator>
    <camera type="perspective">
        <float name="fov" value="40"/>
        <boolean name="mapSmallerSide" value="false"/>
        <transform name="toWorld"><lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/></transform>
        <film type="exrfilm"><integer name="width" value="8"/><integer name="height" value="6"/>
            <boolean name="alpha" value="false"/></film>
    </camera>
    <shape type="rectangle"><bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf></shape>
    <shape type="rectangle">
        <transform name="toWorld"><translate y="3"/></transform>
        <luminaire type="area"><rgb name="intensity" value="5, 5, 5"/></luminaire>
    </shape>
</scene>
"""), {}


def case_legacy_pre_0_3(d):
    return _write(d, "ancient.xml", """\
<scene version="0.2.1">
    <integrator type="path"/>
    <camera type="perspective">
        <transform name="toWorld">
            <lookAt ox="0" oy="1" oz="4" tx="0" ty="1" tz="0" ux="0" uy="1" uz="0"/>
        </transform>
        <film type="exrfilm"><integer name="width" value="8"/><integer name="height" value="8"/></film>
    </camera>
    <shape type="rectangle"><bsdf type="mirror"/></shape>
    <shape type="sphere"/>
    <shape type="cylinder"><point name="p1" x="0" y="0" z="0"/><point name="p2" x="0" y="1" z="0"/>
        <float name="radius" value="0.2"/></shape>
    <shape type="rectangle"><bsdf type="lambertian"/></shape>
</scene>
"""), {}


def case_materials_and_lights(d):
    """Every BSDF family the port has, the adapters, delta lights, a
    blackbody emitter, a thin lens with the LD sampler and the Lanczos
    filter."""
    bsdfs = [
        '<bsdf type="roughdiffuse"><float name="alpha" value="0.3"/></bsdf>',
        '<bsdf type="conductor"><string name="material" value="Au"/></bsdf>',
        '<bsdf type="roughdielectric"><float name="alpha" value="0.2"/>'
        '<string name="distribution" value="beckmann"/><float name="cauchyB" value="0.01"/></bsdf>',
        '<bsdf type="thindielectric"/>',
        '<bsdf type="plastic"><rgb name="diffuseReflectance" value="0.1, 0.2, 0.3"/>'
        '<boolean name="nonlinear" value="true"/></bsdf>',
        '<bsdf type="phong"><float name="exponent" value="20"/></bsdf>',
        '<bsdf type="ward"><float name="alphaU" value="0.1"/><float name="alphaV" value="0.3"/></bsdf>',
        '<bsdf type="difftrans"/>',
        '<bsdf type="blendbsdf"><float name="weight" value="0.3"/><bsdf type="diffuse"/>'
        '<bsdf type="conductor"/></bsdf>',
        '<bsdf type="mixturebsdf"><string name="weights" value="0.2, 0.6"/><bsdf type="diffuse"/>'
        '<bsdf type="roughconductor"/></bsdf>',
        '<bsdf type="roughcoating"><float name="alpha" value="0.2"/><rgb name="sigmaA" '
        'value="0.1, 0.2, 0.3"/><bsdf type="diffuse"/></bsdf>',
        '<bsdf type="hk"><rgb name="sigmaT" value="1, 2, 3"/><phase type="hg">'
        '<float name="g" value="0.4"/></phase></bsdf>',
        '<bsdf type="twosided"><bsdf type="diffuse"/></bsdf>',
        '<bsdf type="normalmap"><texture type="checkerboard"/><bsdf type="diffuse"/></bsdf>',
        '<bsdf type="null"/>',
    ]
    shapes = "".join(f'<shape type="rectangle"><transform name="toWorld"><translate x="{i}"/>'
                     f'</transform>{b}</shape>' for i, b in enumerate(bsdfs))
    lights = ('<emitter type="point"><point name="position" x="0" y="2" z="0"/>'
              '<rgb name="intensity" value="3, 2, 1"/></emitter>'
              '<emitter type="spot"><transform name="toWorld"><lookat origin="0, 3, 0" '
              'target="0, 0, 0" up="1, 0, 0"/></transform><float name="cutoffAngle" value="30"/>'
              '<rgb name="intensity" value="5, 5, 5"/></emitter>'
              '<emitter type="directional"><vector name="direction" x="0" y="-1" z="1"/>'
              '<rgb name="irradiance" value="1, 1, 1"/></emitter>'
              '<shape type="disk"><emitter type="area"><blackbody name="radiance" '
              'temperature="3200" scale="2"/></emitter></shape>'
              '<emitter type="constant"><srgb name="radiance" value="0.2, 0.3, 0.4"/></emitter>')
    sensor_xml = ('<sensor type="thinlens"><float name="apertureRadius" value="0.05"/>'
                  '<float name="focusDistance" value="3"/><string name="fovAxis" value="y"/>'
                  '<sampler type="ldsampler"><integer name="sampleCount" value="4"/></sampler>'
                  + _film(8, 6, '<rfilter type="lanczos"/>') + '</sensor>')
    return _write(d, "s.xml", _scene(shapes + lights, sensor_xml=sensor_xml)), {}


def case_shapes_and_motion(d):
    """Meshes from files (OBJ with usemtl, serialized, PLY), analytic
    shapes, a heightfield, shape groups and instances, a mirrored
    instance, animated toWorldEnd and a deformable mesh at time 0.3, a
    moving camera and the sobol sampler."""
    from mitsuba_tpu.io import mesh as j_mesh, serialized as j_ser

    (d / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 1\n"
                             "vn 0 0 1\nusemtl a\nf 1/1/1 2/2/1 3/1/1 4/2/1\n")
    rs = np.random.RandomState(3)
    j_ser.write_serialized(d / "m.serialized", [
        j_mesh.MeshData(rs.uniform(-1, 1, (5, 3)), rs.randint(0, 5, (3, 3))),
        j_mesh.MeshData(rs.uniform(-1, 1, (6, 3)), rs.randint(0, 6, (4, 3)),
                        normals=rs.uniform(-1, 1, (6, 3)))])
    _ply_colors(d / "c.ply")
    j_mesh.save_obj(d / "k0.obj", rs.uniform(0, 1, (4, 3)), [[0, 1, 2], [0, 2, 3]])
    j_mesh.save_obj(d / "k1.obj", rs.uniform(0, 1, (4, 3)), [[0, 1, 2], [0, 2, 3]])
    j_image.write_pfm(d / "h.pfm", rs.uniform(0, 1, (5, 6)).astype(np.float32))
    body = (
        '<shape type="obj"><string name="filename" value="m.obj"/><transform name="toWorld">'
        '<scale x="2" y="1" z="1"/></transform><transform name="toWorldEnd"><rotate y="1" '
        'angle="40"/><translate x="1"/></transform></shape>'
        '<shape type="serialized"><string name="filename" value="m.serialized"/>'
        '<integer name="shapeIndex" value="1"/></shape>'
        '<shape type="ply"><string name="filename" value="c.ply"/>'
        '<boolean name="faceNormals" value="true"/></shape>'
        '<shape type="cylinder"><float name="radius" value="0.3"/></shape>'
        '<shape type="heightfield"><string name="filename" value="h.pfm"/>'
        '<float name="scale" value="0.5"/></shape>'
        '<shape type="deformable"><string name="filename0" value="k0.obj"/>'
        '<string name="filename1" value="k1.obj"/></shape>'
        '<shape type="shapegroup" id="grp"><shape type="cube"><bsdf type="conductor"/></shape>'
        '<shape type="sphere"><float name="radius" value="0.2"/></shape></shape>'
        '<shape type="instance"><ref id="grp"/><transform name="toWorld"><translate y="2"/>'
        '</transform></shape>'
        '<shape type="instance"><ref id="grp"/><transform name="toWorld"><scale x="-1"/>'
        '</transform></shape>')
    sensor_xml = ('<sensor type="perspective"><transform name="toWorld"><lookat origin="0, 1, 5" '
                  'target="0, 0, 0"/></transform><transform name="toWorldEnd"><lookat '
                  'origin="0.2, 1, 5" target="0, 0, 0"/></transform>'
                  '<sampler type="sobol"><integer name="sampleCount" value="8"/></sampler>'
                  + _film() + '</sensor>')
    return _write(d, "s.xml", _scene(body, sensor_xml=sensor_xml)), {"time": 0.3}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loads_like_jax(tmp_path, name):
    p, kw = CASES[name](tmp_path)
    runs = [(p, kw)]
    if name == "defaults":
        runs.append((p, {}))
    if name == "rfilter":
        runs = [(tmp_path / f"{f}.xml", {}) for f in FILTERS]
    for p, kw in runs:
        scene, cam, cfg, _ = load_both(p, **kw)
        assert scene.device.type == "cpu" and cam.to_world.device.type == "cpu"


def test_plugin_type_substitution(tmp_path):
    """C35: `$key` in a plugin's type attribute (`-D film=tiledhdrfilm`)
    is substituted, as Mitsuba's SceneHandler does; the JAX loader
    substitutes property values only, so there the film stays hdrfilm."""
    text = _scene('<shape type="cube"/>', sensor_xml=_sensor(film=(
        '<film type="$film"><integer name="width" value="8"/>'
        '<integer name="height" value="8"/></film>')))
    p = _write(tmp_path, "s.xml", text.replace(
        '<scene version="0.6.0">', '<scene version="0.6.0"><default name="film" value="hdrfilm"/>'))
    assert not xml.load_xml(p, device="cpu")[2].film_tiled
    tiled = {"defaults": {"film": "tiledhdrfilm"}}
    assert xml.load_xml(p, device="cpu", **tiled)[2].film_tiled
    assert not j_xml.load_xml(p, **tiled)[2].film_tiled


ERROR_CASES = {
    "typo": ('<shape type="rectangle"><bsdf type="diffuse"><rgb name="reflectanse" '
             'value="0.5,0.5,0.5"/></bsdf></shape>', ValueError, "reflectanse"),
    "element": ('<shape type="cube"/><subsurfacezzz type="nope"/>', ValueError,
                "unsupported scene element"),
    "shape_plugin": ('<shape type="nurbs"/>', ValueError, "unsupported shape plugin 'nurbs'"),
    "bsdf_plugin": ('<shape type="cube"><bsdf type="velvet"/></shape>', ValueError,
                    "unsupported bsdf plugin 'velvet'"),
    "emitter_plugin": ('<emitter type="laser"/>', ValueError, "unsupported emitter plugin"),
    "unknown_ior": ('<shape type="cube"><bsdf type="dielectric"><string name="intIOR" '
                    'value="unobtainium"/></bsdf></shape>', ValueError, "unknown IOR"),
    "missing_file": ('<shape type="obj"><string name="filename" value="none.obj"/></shape>',
                     FileNotFoundError, "none.obj"),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_rejects_like_jax(tmp_path, name):
    body, exc, match = ERROR_CASES[name]
    p = _write(tmp_path, "bad.xml", _scene(body))
    with pytest.raises(exc, match=match):
        j_xml.load_xml(p)
    with pytest.raises(exc, match=match):
        xml.load_xml(p, device="cpu")


def test_search_path_needed(tmp_path):
    """Without the search path the bitmap is not found, in both packages."""
    p, _ = case_search_paths(tmp_path)
    with pytest.raises(FileNotFoundError):
        j_xml.load_xml(p)
    with pytest.raises(FileNotFoundError):
        xml.load_xml(p, device="cpu")


UNPORTED = {
    "sun": '<emitter type="sun"/>',
    "sky": '<emitter type="sky"><float name="turbidity" value="3"/></emitter>',
    "sunsky": '<emitter type="sunsky"><vector name="sunDirection" x="0" y="1" z="0"/></emitter>',
    "irawan": '<shape type="cube"><bsdf type="irawan"><string name="preset" '
              'value="cotton"/></bsdf></shape>',
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_models_raise(tmp_path, name):
    """The models that raised until they were ported (the sun/sky emitters,
    the Irawan cloth BSDF) load equal to the JAX loads: the baked envmap
    and its band stack within C10's bar, the cloth tables bit for bit but
    their spec_norm column (C10's bar; a Monte Carlo mean of 10,000 lanes
    on the JAX package's threefry draws)."""
    p = _write(tmp_path, "s.xml", _scene('<shape type="cube"/>' + UNPORTED[name]))
    scene = load_both(p)[0]
    if name == "irawan":
        assert scene.cloth is not None and ir.BSDF_IRAWAN in scene.bsdf_families
        assert float(scene.cloth.patp[0, 7]) > 0          # the spec_norm
    else:
        assert scene.has_env and scene.envmap.image.shape == (256, 512, 3)
        assert scene.envmap.spectral.shape == (256, 512, 11)


def test_unused_properties_are_per_load(tmp_path):
    """C34: the JAX loader keeps its unused-property list in a module
    global that every load_xml clears, so concurrent loads (the CLI's -j
    thread pool) clear and fill each other's list. The port keeps the list
    on each load's _Loader: in threads, a good scene always loads and a
    scene with a typo always fails naming its own property."""
    good, _ = case_cornell(tmp_path)
    bad = _write(tmp_path, "bad.xml", _scene(
        '<shape type="rectangle"><bsdf type="diffuse"><rgb name="reflectanse" '
        'value="0.5,0.5,0.5"/></bsdf></shape>'))
    results = {"good": [], "bad": []}

    def run(kind, p):
        for _ in range(6):
            try:
                xml.load_xml(p, device="cpu")
                results[kind].append("loaded")
            except ValueError as e:
                results[kind].append(str(e))

    threads = [threading.Thread(target=run, args=(k, p)) for k, p in
               (("good", good), ("bad", bad), ("good", good), ("bad", bad))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results["good"] == ["loaded"] * 12
    assert len(results["bad"]) == 12
    for msg in results["bad"]:
        assert "'reflectanse'" in msg and msg.count("unknown or unused property") == 1
    assert not hasattr(xml, "_ALL_PROPS")


@pytest.fixture(scope="module")
def cornell_renders(tmp_path_factory):
    """CORNELL_XML (8x8, 4 spp, LD sampler, depth 4, 4,036 triangles)
    loaded and rendered through both packages, the JAX render jitted
    once."""
    p, _ = case_cornell(tmp_path_factory.mktemp("cornell"))
    jscene, jcam, jcfg, _ = j_xml.load_xml(p)
    ref = np.asarray(j_common.render_jit(jscene, jcam, j_path.li, jcfg))
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    return common.render(scene, cam, path.li, cfg).numpy(), ref


def test_loaded_cornell_renders_like_jax(cornell_renders):
    """Measured: max diff 1.2e-7."""
    img, ref = cornell_renders
    assert img.shape == ref.shape == (8, 8, 3)
    np.testing.assert_allclose(img, ref, rtol=RENDER_TOL, atol=RENDER_TOL)
    assert img.mean() > 0.01


def test_loader_builds_on_the_card_by_default(tmp_path):
    """load_xml defaults to device="cuda": without a card that raises (no
    silent CPU load)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default load succeeds")
    p, _ = case_cornell(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        xml.load_xml(p)


def test_config_from_jax():
    """Every field the port has is carried; a JAX field the port lacks
    raises unless it holds its default."""
    jcfg = j_common.RenderConfig(spp=3, max_depth=5, rr_depth=2, seed=9, filter=4, sampler=5,
                                 mis_mode=1, hide_emitters=True, occupancy_shadows=True,
                                 ao_length=2.0, film_tiled=True, cauchy_b=0.02,
                                 strict_normals=True)
    cfg = common.config_from_jax(jcfg)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == \
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    assert cfg.occupancy_shadows and cfg.ao_length == 2.0
    with pytest.raises(NotImplementedError, match="unroll"):
        common.config_from_jax(dataclasses.replace(jcfg, unroll=False))


def test_blackbody_spectrum_alike():
    """planck and rgb_response, which <blackbody> reads, against the JAX
    package's core/spectrum.py at C10's bar; the colour matching
    functions and the hero-wavelength helpers likewise."""
    import jax.numpy as jnp

    from mitsuba_tpu.core import spectrum as jspec
    from mitsuba_tpu_torch.core import spectrum as tspec

    lam = np.linspace(380.0, 720.0, 97).astype(np.float32)
    lt, lj = torch.as_tensor(lam), jnp.asarray(lam)
    pairs = [(tspec.planck(lt, 3200.0), jspec.planck(lj, 3200.0)),
             (tspec.planck(lt, 6500.0), jspec.planck(lj, 6500.0)),
             (tspec.rgb_response(lt), jspec.rgb_response(lj)),
             (tspec.xyz_cmf(lt), jspec.xyz_cmf(lj))]
    u = torch.as_tensor(np.random.RandomState(0).uniform(0, 1, 64).astype(np.float32))
    lams = tspec.sample_lambdas(u)
    rgb = torch.as_tensor(np.random.RandomState(1).uniform(0, 1, (64, 3)).astype(np.float32))
    lj4, rj = jnp.asarray(lams.numpy()), jnp.asarray(rgb.numpy())
    pairs += [(lams, jspec.sample_lambdas(jnp.asarray(u.numpy()))),
              (tspec.upsample(rgb, lams), jspec.upsample(rj, lj4)),
              (tspec.upsample_reflectance(rgb, lams), jspec.upsample_reflectance(rj, lj4)),
              (tspec.to_rgb(rgb[:, :1].expand(64, 4), lams),
               jspec.to_rgb(jnp.broadcast_to(rj[:, :1], (64, 4)), lj4)),
              (tspec.cauchy_eta(torch.tensor(1.5), 0.01, lams), jspec.cauchy_eta(1.5, 0.01, lj4))]
    for mine, ref in pairs:
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=C10_RTOL, atol=C10_ATOL)
