"""The port's file readers and writers (mitsuba_tpu_torch/io) against the
JAX package's (mitsuba_tpu/io): every image, mesh and volume format written
by one package and read by both, both ways, with the arrays equal bit for
bit; where both packages write a format, the files are byte-equal (apart
from the EXR attributes renderTime and generatedBy, which name the run).
Also the PIZ decoder's stages on the same seeded bytes, the OBJ parser's
cases (against the JAX loader, whichever parser it took), and Pillow's
absence raising."""
import struct
import sys
import zlib

import numpy as np
import pytest

from mitsuba_tpu.io import (exr_piz as j_piz, hair as j_hair, image as j_image,
                            mesh as j_mesh, serialized as j_ser, vol as j_vol)
from mitsuba_tpu_torch.io import (exr_piz as t_piz, hair as t_hair, image as t_image,
                                  mesh as t_mesh, serialized as t_ser, vol as t_vol)

PACKAGES = {"jax": (j_image, j_mesh, j_ser, j_hair, j_vol),
            "torch": (t_image, t_mesh, t_ser, t_hair, t_vol)}


def _img(seed, shape=(9, 13, 3), lo=0.0, hi=4.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=True)


# each image format: (file name, writer(image module, path, img), reader name)
IMAGE_FORMATS = {
    "exr": ("t.exr", lambda m, p, im: m.write_exr(p, im, metadata={"spp": 16.0, "note": "x"}),
            "read_exr"),
    "exr_half": ("t.exr", lambda m, p, im: m.write_exr(p, im, half=True), "read_exr"),
    "exr_gray": ("t.exr", lambda m, p, im: m.write_exr(p, im[..., 0]), "read_exr"),
    "pfm": ("t.pfm", lambda m, p, im: m.write_pfm(p, im), "read_pfm"),
    "pfm_gray": ("t.pfm", lambda m, p, im: m.write_pfm(p, im[..., 0]), "read_pfm"),
    "png": ("t.png", lambda m, p, im: m.write_png(p, im / 4.0), "read_png"),
    "png_linear": ("t.png", lambda m, p, im: m.write_png(p, im / 4.0, tonemap=False),
                   "read_png"),
    "hdr": ("t.hdr", lambda m, p, im: m.write_rgbe(p, im), "read_rgbe"),
    "npy": ("t.npy", lambda m, p, im: m.write_npy(p, im), "read_auto"),
    "bmp": ("t.bmp", lambda m, p, im: m.write_ldr_pil(p, im / 4.0), "read_auto"),
}


@pytest.mark.parametrize("fmt", sorted(IMAGE_FORMATS))
def test_image_format_both_ways(tmp_path, fmt):
    """Written by each package: the two files byte-equal, and each read by
    both packages' readers (the format's own and read_auto) to the same
    array."""
    name, write, reader = IMAGE_FORMATS[fmt]
    img = _img(1)
    files = {}
    for pkg, (image, *_) in PACKAGES.items():
        files[pkg] = tmp_path / pkg / name
        files[pkg].parent.mkdir()
        write(image, files[pkg], img)
    assert files["jax"].read_bytes() == files["torch"].read_bytes()
    for path in files.values():
        got = {pkg: getattr(image, reader)(path) for pkg, (image, *_) in PACKAGES.items()}
        _equal(got["jax"], got["torch"])
        _equal(t_image.read_auto(str(path)), j_image.read_auto(str(path)))


def test_exr_attrs_and_write_image(tmp_path):
    """write_image with the CLI's metadata: the files differ only in the
    renderTime and generatedBy values; read_exr_attrs reads them alike."""
    img = _img(2)
    for pkg, gen in (("jax", "mitsuba_tpu"), ("torch", "mitsuba_tpu_torch")):
        image = PACKAGES[pkg][0]
        image.write_image(tmp_path / f"{pkg}.exr", img,
                          metadata={"renderTime": 1.5 if pkg == "jax" else 2.5,
                                    "spp": 64.0, "generatedBy": gen})
    attrs = {pkg: [m.read_exr_attrs(tmp_path / f"{pkg}.exr") for m in (j_image, t_image)]
             for pkg in ("jax", "torch")}
    for a, b in attrs.values():
        assert a == b
    ja, ta = attrs["jax"][0], attrs["torch"][0]
    assert (ja["renderTime"], ta["renderTime"]) == (1.5, 2.5)
    assert ja["spp"] == ta["spp"] == 64.0
    assert {k: v for k, v in ja.items() if k not in ("renderTime", "generatedBy")} == \
        {k: v for k, v in ta.items() if k not in ("renderTime", "generatedBy")}
    _equal(j_image.read_exr(tmp_path / "jax.exr"), t_image.read_exr(tmp_path / "torch.exr"))
    # with the same two values, the files are byte-equal
    for pkg in PACKAGES:
        PACKAGES[pkg][0].write_image(tmp_path / f"{pkg}.exr", img, metadata={
            "renderTime": 1.5, "spp": 64.0, "generatedBy": "mitsuba_tpu"})
    assert (tmp_path / "jax.exr").read_bytes() == (tmp_path / "torch.exr").read_bytes()


def test_tiled_writer_equals_jax_exr(tmp_path):
    """film/tiled.py's TiledEXRWriter, its bands written out of order, makes
    the JAX write_exr's file byte for byte (the header it shares with
    io/image.py checked against the JAX package's), and the JAX reader
    gives its pixels back bit for bit; rows never written read as zeros."""
    from mitsuba_tpu_torch.film.tiled import TiledEXRWriter

    img = _img(3, shape=(10, 7, 3))
    meta = {"spp": 16.0, "generatedBy": "mitsuba_tpu_torch"}
    writer = TiledEXRWriter(tmp_path / "tiled.exr", 7, 10, metadata=meta)
    for y0 in (6, 0, 2, 8, 4):
        writer.write_rows(y0, img[y0:y0 + 2])
    writer.close()
    j_image.write_exr(tmp_path / "jax.exr", img, metadata=meta)
    assert (tmp_path / "tiled.exr").read_bytes() == (tmp_path / "jax.exr").read_bytes()
    _equal(j_image.read_exr(tmp_path / "tiled.exr"), img)
    partial = TiledEXRWriter(tmp_path / "partial.exr", 7, 10)
    partial.write_rows(4, img[4:7])
    partial.close()
    want = np.zeros_like(img)
    want[4:7] = img[4:7]
    _equal(j_image.read_exr(tmp_path / "partial.exr"), want)


def _exr_predict(raw: bytes) -> bytes:
    """OpenEXR's zip predictor (the inverse of _exr_unpredict): split even
    and odd bytes, then delta-encode with +128."""
    a = np.frombuffer(raw, np.uint8)
    inter = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
    out = inter.copy()
    out[1:] = (inter[1:] - inter[:-1] + 128) & 0xFF
    return out.astype(np.uint8).tobytes()


def _zip_exr(path, img):
    """A ZIP-compressed (16-line blocks) half RGB scanline EXR, built by
    hand: neither package writes one."""
    h, w = img.shape[:2]
    chans = b"".join(c + b"\x00" + struct.pack("<iiii", 1, 0, 1, 1) for c in (b"B", b"G", b"R"))
    attrs = [(b"channels", b"chlist", chans + b"\x00"), (b"compression", b"compression", b"\x03"),
             (b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))]
    header = b"".join(n + b"\x00" + t + b"\x00" + struct.pack("<i", len(d)) + d
                      for n, t, d in attrs) + b"\x00"
    blocks = []
    for y in range(0, h, 16):
        rows = img[y:y + 16].astype(np.float16)
        raw = b"".join(rows[r, :, c].tobytes() for r in range(rows.shape[0]) for c in (2, 1, 0))
        blocks.append(struct.pack("<i", y) + (lambda z: struct.pack("<i", len(z)) + z)(
            zlib.compress(_exr_predict(raw))))
    pre = struct.pack("<ii", 20000630, 2) + header
    offs, pos = [], len(pre) + 8 * len(blocks)
    for b in blocks:
        offs.append(pos)
        pos += len(b)
    path.write_bytes(pre + struct.pack(f"<{len(offs)}Q", *offs) + b"".join(blocks))


def test_zip_exr_read_alike(tmp_path):
    img = _img(3, (21, 10, 3))
    _zip_exr(tmp_path / "z.exr", img)
    a, b = j_image.read_exr(tmp_path / "z.exr"), t_image.read_exr(tmp_path / "z.exr")
    _equal(a, b)
    _equal(b, img.astype(np.float16).astype(np.float32))


def test_exr_unpredict_alike():
    data = np.random.RandomState(4).randint(0, 256, 1001).astype(np.uint8)
    _equal(t_image._exr_unpredict(data), j_image._exr_unpredict(data))
    raw = np.random.RandomState(5).randint(0, 256, 600).astype(np.uint8).tobytes()
    assert t_image._exr_unpredict(np.frombuffer(_exr_predict(raw), np.uint8)).tobytes() == raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piz_huffman_stages_alike(seed):
    """The Huffman stages on the same seeded bytes: the bit reader, the
    code-length table with its zero runs and the canonical codes, the
    bit-serial decode with its run-length symbol."""
    data = np.random.RandomState(seed).randint(0, 256, 4096).astype(np.uint8).tobytes()
    readers = [mod._BitReader(data) for mod in (j_piz, t_piz)]
    assert [readers[0].get_bits(n) for n in (1, 5, 13, 8, 3)] == \
        [readers[1].get_bits(n) for n in (1, 5, 13, 8, 3)]
    tables = [mod._unpack_enc_table(mod._BitReader(data), 3, 700) for mod in (j_piz, t_piz)]
    _equal(*tables)
    assert np.count_nonzero(tables[0]) > 10
    outs = []
    for mod, hcode in zip((j_piz, t_piz), tables):
        br = mod._BitReader(data[1024:])
        outs.append(mod._huf_decode(hcode, br, 700, 500, 8 * 2000))
    _equal(*outs)


@pytest.mark.parametrize("mx", [1000, 40000])
def test_piz_wavelet_alike(mx):
    """wav2_decode in place on a seeded (odd x odd) plane, the 14-bit
    and the 16-bit lifting."""
    plane = np.random.RandomState(mx).randint(0, 1 << 16, (37, 29)).astype(np.uint16)
    a, b = plane.copy(), plane.copy()
    j_piz.wav2_decode(a, mx)
    t_piz.wav2_decode(b, mx)
    _equal(a, b)
    assert not np.array_equal(a, plane)


def test_piz_block_alike():
    """piz_uncompress of one block built from seeded bytes: the bitmap and
    its reverse LUT, the Huffman stream (its header pointing inside the
    bytes), the per-channel wavelet, the LUT lookup and the half decode."""
    rs = np.random.RandomState(7)
    bitmap = rs.randint(0, 256, 64).astype(np.uint8).tobytes()
    huf = rs.randint(0, 256, 3000).astype(np.uint8).tobytes()
    huf = struct.pack("<IIIII", 0, 400, 0, 8 * 1500, 0) + huf
    block = struct.pack("<HH", 10, 10 + len(bitmap) - 1) + bitmap + struct.pack("<I", len(huf)) + huf
    chans = [("B", 1), ("G", 1), ("R", 1)]
    a = j_piz.piz_uncompress(block, chans, 12, 7)
    b = t_piz.piz_uncompress(block, chans, 12, 7)
    assert sorted(a) == sorted(b) == ["B", "G", "R"]
    for c in a:
        _equal(a[c], b[c])


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

def _mesh_fields(md):
    return {k: getattr(md, k) for k in ("vertices", "indices", "normals", "uvs", "colors")}


def _same_mesh(a, b, groups=True):
    fa, fb = _mesh_fields(a), _mesh_fields(b)
    for k in fa:
        if fa[k] is None or fb[k] is None:
            assert fa[k] is None and fb[k] is None, k
        else:
            _equal(fa[k], fb[k])
    if groups:
        assert a.face_groups == b.face_groups


def test_save_obj_both_ways(tmp_path):
    verts = _img(8, (40, 3), -2, 2)
    tris = np.random.RandomState(9).randint(0, 40, (25, 3)).astype(np.int32)
    order = np.unique(tris.ravel(), return_index=True)[1]
    used = tris.ravel()[np.sort(order)]      # first-appearance order
    for pkg, (_, mesh, *_) in PACKAGES.items():
        mesh.save_obj(tmp_path / f"{pkg}.obj", verts, tris)
    assert (tmp_path / "jax.obj").read_bytes() == (tmp_path / "torch.obj").read_bytes()
    md = t_mesh.load_obj(tmp_path / "jax.obj")
    _same_mesh(md, j_mesh.load_obj(tmp_path / "torch.obj"), groups=False)
    # float32 reprs read back exactly; corners in first-appearance order
    _equal(md.vertices, verts[used])
    _equal(md.vertices[md.indices], verts[tris])


OBJ_CASES = {
    "v_vt_vn": """\
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0.5
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/1
f 2/2/2 4/3/2 3/1/2
""",
    "negative_indices": """\
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
f -3/-3/-1 -2/-2/-1 -1/-1/-1
v 2 2 2
f -4 -3 -1
""",
    "polygon_fans": """\
v 0 0 0
v 1 0 0
v 1.5 1 0
v 0.5 2 0
v -0.5 1 0
v 3 3 3
f 1 2 3 4 5
f 2 6 3 4
f 1//0 2 6
""".replace("f 1//0 2 6", "f 1 2 6"),
    "usemtl_groups": """\
# two materials
mtllib scene.mtl
o box
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0.25 0.5
usemtl red
f 1/1 2/1 3/1
f 1 3 4
usemtl
f 1 4 5
usemtl white
g side
s 1
f 2 5 3
""",
}


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_obj_parser_cases(tmp_path, case, monkeypatch):
    """Against the JAX loader as it runs here (its native parser where the
    library is built, which keeps no usemtl groups) and against its
    Python parser: the same vertices, indices, normals and uvs, and the
    Python parser's groups."""
    p = tmp_path / "m.obj"
    p.write_text(OBJ_CASES[case])
    mine = t_mesh.load_obj(p)
    _same_mesh(mine, j_mesh.load_obj(p), groups=False)
    from mitsuba_tpu import native

    monkeypatch.setattr(native, "parse_obj", lambda path: None)
    _same_mesh(mine, j_mesh.load_obj(p))
    assert len(mine.face_groups) == mine.indices.shape[0]
    if case == "usemtl_groups":
        assert mine.face_groups == ["red", "red", "", "white"]
    if case == "polygon_fans":
        assert mine.indices.shape == (3 + 2 + 1, 3)


def _ply_ascii(path):
    path.write_text("""\
ply
format ascii 1.0
comment made by hand
element vertex 5
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 2
property list uchar int vertex_indices
element edge 1
property int vertex1
property int vertex2
end_header
-1 0 -1 255 0 0
1 0 -1 0 255 0
1 0 1 0 0 255
-1 0 1 255 255 0
0 1 0 10 20 30
3 0 2 1
4 0 3 2 4
0 1
""")


def _ply_binary(path):
    rs = np.random.RandomState(10)
    n = 7
    vert = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f4"),
                              ("ny", "<f4"), ("nz", "<f4"), ("s", "<f4"), ("t", "<f4")])
    for k in vert.dtype.names:
        vert[k] = rs.uniform(-1, 1, n)
    faces = b"".join(struct.pack("<B", 3) + struct.pack("<3I", *rs.randint(0, n, 3))
                     for _ in range(4))
    faces += struct.pack("<B", 4) + struct.pack("<4I", 0, 1, 2, 3)
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 7\n"
            + "".join(f"property float {k}\n" for k in vert.dtype.names)
            + "element face 5\nproperty list uchar uint vertex_indices\nend_header\n")
    path.write_bytes(head.encode() + vert.tobytes() + faces)


@pytest.mark.parametrize("kind", ["ascii_colors", "binary_normals_uvs"])
def test_ply_read_alike(tmp_path, kind):
    p = tmp_path / "m.ply"
    (_ply_ascii if kind == "ascii_colors" else _ply_binary)(p)
    a, b = j_mesh.load_ply(p), t_mesh.load_ply(p)
    _same_mesh(a, b)
    if kind == "ascii_colors":
        _equal(b.colors[0], np.asarray([1, 0, 0], np.float32))
        assert b.indices.shape == (3, 3)
    else:
        assert b.normals is not None and b.uvs is not None and b.indices.shape == (6, 3)


def test_serialized_both_ways(tmp_path):
    rs = np.random.RandomState(11)
    meshes = {}
    for pkg, (_, mesh, ser, *_) in PACKAGES.items():
        mds = [mesh.MeshData(rs.uniform(-1, 1, (6, 3)), rs.randint(0, 6, (4, 3)),
                             normals=rs.uniform(-1, 1, (6, 3)), uvs=rs.uniform(0, 1, (6, 2))),
               mesh.MeshData(rs.uniform(-1, 1, (5, 3)), rs.randint(0, 5, (3, 3)))]
        rs = np.random.RandomState(11)       # the same meshes for both
        mds[1].name = "second"
        ser.write_serialized(tmp_path / f"{pkg}.serialized", mds)
        meshes[pkg] = mds
    assert (tmp_path / "jax.serialized").read_bytes() == \
        (tmp_path / "torch.serialized").read_bytes()
    for pkg in PACKAGES:
        f = tmp_path / f"{pkg}.serialized"
        a, b = j_ser.read_serialized(f), t_ser.read_serialized(f)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            _same_mesh(x, y)
            assert x.name == y.name
        _same_mesh(j_ser.read_serialized(f, 1), t_ser.read_serialized(f, 1))
    with pytest.raises(ValueError, match="out of range"):
        t_ser.read_serialized(tmp_path / "torch.serialized", 2)


def test_hair_both_ways(tmp_path):
    strands = [_img(12, (4, 3), -1, 1), _img(13, (2, 3), -1, 1), _img(14, (1, 3))]
    for pkg, (*_, hair, _vol) in PACKAGES.items():
        hair.write_hair_ascii(tmp_path / f"{pkg}.hair", strands)
    assert (tmp_path / "jax.hair").read_bytes() == (tmp_path / "torch.hair").read_bytes()
    buf = b"BINARY_HAIR" + struct.pack("<I", 5)
    buf += struct.pack("<4f", float("inf"), 0, 0, 0) + struct.pack("<3f", 0, 1, 0)
    buf += struct.pack("<4f", float("inf"), 1, 0, 0) + struct.pack("<3f", 1, 1, 0)
    buf += struct.pack("<3f", 1, 2, 0.25)
    (tmp_path / "b.hair").write_bytes(buf)
    for name in ("jax.hair", "torch.hair", "b.hair"):
        a, b = j_hair.read_hair(tmp_path / name), t_hair.read_hair(tmp_path / name)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("channels", [1, 3])
def test_vol_both_ways(tmp_path, channels):
    shape = (4, 5, 6) + ((3,) if channels == 3 else ())
    data = _img(15, shape, 0, 2)
    for pkg, (*_, vol) in PACKAGES.items():
        vol.write_vol(tmp_path / f"{pkg}.vol", data, (-1, -2, -3), (1, 2, 3.5))
    assert (tmp_path / "jax.vol").read_bytes() == (tmp_path / "torch.vol").read_bytes()
    for pkg in PACKAGES:
        a, b = j_vol.read_vol(tmp_path / f"{pkg}.vol"), t_vol.read_vol(tmp_path / f"{pkg}.vol")
        for x, y in zip(a, b):
            _equal(x, y)
        _equal(b[0], data)


def test_hgrid_both_ways(tmp_path):
    table = np.asarray([[[0, -1], [1, -1]], [[-1, 2], [-1, -1]]], np.int32)
    blocks = _img(16, (3, 4, 4, 4), 0, 1)
    for pkg, (*_, vol) in PACKAGES.items():
        (tmp_path / pkg).mkdir()
        vol.write_hgrid(tmp_path / pkg / "d.hgrid", "blk_", table, blocks, (0, 0, 0), (2, 2, 2))
    for f in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes(), f
    for pkg in PACKAGES:
        a = j_vol.read_hgrid(tmp_path / pkg / "d.hgrid", "blk_")
        b = t_vol.read_hgrid(tmp_path / pkg / "d.hgrid", "blk_")
        for x, y in zip(a, b):
            _equal(x, y)
        _equal(b[0], table)


@pytest.mark.parametrize("ext", ["jpg", "ppm", "tga", "bmp", "gif"])
def test_without_pillow_ldr_raises_naming_format(tmp_path, monkeypatch, ext):
    """Without Pillow (the GPU machine has none) the LDR formats raise a
    ValueError naming the format, reading and writing alike, and no other
    reader is tried."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    p = tmp_path / f"t.{ext}"
    p.write_bytes(b"not an image")
    with pytest.raises(ValueError, match=f"reading {ext.upper()} images .*Pillow"):
        t_image.read_auto(str(p))
    if ext != "gif":
        with pytest.raises(ValueError, match=f"writing {ext.upper()} images .*Pillow"):
            t_image.write_image(str(p), _img(17, (4, 4, 3), 0, 1))
    with pytest.raises(ValueError, match="unsupported image format"):
        t_image.read_auto(str(tmp_path / "t.xyz"))
