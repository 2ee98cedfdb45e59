"""Scene-version auto-upgrade (data/schema/upgrade_*.xsl parity; a copy of
the JAX package's scene/upgrade.py).

The reference runs a chain of XSLT transforms to lift old scenes to the
current format (scenehandler loads upgrade_0.3.0.xsl .. upgrade_0.6.0.xsl
in sequence). This module re-implements the same rewrite rules as
in-place ElementTree transforms, applied by scene/xml.py when
<scene version="..."> is older than 0.6:

  pre-0.3 -> 0.3 (upgrade_0.3.0.xsl): old lookAt ox/oy/.. attributes
    (+ handedness flip), default-diffuse for bare shapes, OBJ
    flipTexCoords, lambertian->diffuse, mirror->conductor(Cr),
    roughmetal->roughconductor, roughglass->roughdielectric,
    microfacet->roughplastic, composite->mixturebsdf, ward alphaX/Y->
    alphaU/V, diffuse/specularAmount folding, exr/ldrtexture->bitmap,
    checkerboard/gridtexture bright/darkColor->color1/color0, sphere
    `inverted`->flipNormals, cylinder p1/p2->p0/p1,
    sizeMultiplier->densityMultiplier;
  0.3 -> 0.4 (upgrade_0.4.0.xsl): camera->sensor (fovAxis from
    mapSmallerSide, toWorld handedness flip), luminaire->emitter,
    intensity->radiance/irradiance, luminaireSamples->emitterSamples,
    sampler depth->dimension, errctrl->adaptive, exrfilm->hdrfilm,
    pngfilm->ldrfilm, film alpha->pixelFormat, focusDepth->
    focusDistance, intensityScale/densityMultiplier->scale;
  0.4 -> 0.5 (upgrade_0.5.0.xsl): bump->bumpmap;
  0.5 -> 0.6 (upgrade_0.6.0.xsl): version bump only.
"""
from __future__ import annotations


def _version_tuple(v: str):
    try:
        return tuple(int(x) for x in v.split(".")[:3])
    except ValueError:
        return (0, 6, 0)


def _scale_reflectance(bsdf, name, amount):
    """Fold diffuse/specularAmount into the reflectance value (the
    xsl's mode="scaled"); numeric colors scale in place, textures wrap
    in a <texture type="scale">."""
    import xml.etree.ElementTree as ET
    node = None
    for c in bsdf:
        if c.attrib.get("name") == name:
            node = c
            break
    if node is None:
        val = 0.5 if name == "diffuseReflectance" else 0.2
        ET.SubElement(bsdf, "spectrum",
                      {"name": name, "value": str(amount * val)})
        return
    if node.tag in ("rgb", "srgb", "spectrum"):
        vals = [float(x) * amount
                for x in node.attrib["value"].replace(",", " ").split()]
        node.attrib["value"] = ", ".join(str(v) for v in vals)
    elif node.tag in ("texture", "ref"):
        bsdf.remove(node)
        wrap = ET.SubElement(bsdf, "texture",
                             {"name": name, "type": "scale"})
        node.attrib.pop("name", None)
        wrap.append(node)
        ET.SubElement(wrap, "float",
                      {"name": "scale", "value": str(amount)})


def _upgrade_pre03(root):
    import xml.etree.ElementTree as ET
    # old lookAt with ox/.. attributes inside transforms (+ hand flip)
    for tf in root.iter("transform"):
        n_inserted = 0  # live children shift right after each insertion
        for i, el in enumerate(list(tf)):
            if el.tag == "lookAt" and "ox" in el.attrib:
                a = el.attrib
                el.attrib = {
                    "origin": f"{a['ox']}, {a['oy']}, {a['oz']}",
                    "target": f"{a['tx']}, {a['ty']}, {a['tz']}",
                }
                if "ux" in a:
                    el.attrib["up"] = f"{a['ux']}, {a['uy']}, {a['uz']}"
                tf.insert(i + n_inserted, ET.Element("scale", {"x": "-1"}))
                n_inserted += 1
    for shape in root.iter("shape"):
        if shape.attrib.get("type") == "obj":
            ET.SubElement(shape, "boolean",
                          {"name": "flipTexCoords", "value": "false"})
        if not any(c.tag in ("bsdf", "ref", "medium", "subsurface")
                   for c in shape):
            ET.SubElement(shape, "bsdf", {"type": "diffuse"})
        if shape.attrib.get("type") == "sphere":
            for c in shape:
                if c.tag == "boolean" and c.attrib.get("name") == "inverted":
                    c.attrib["name"] = "flipNormals"
        if shape.attrib.get("type") == "cylinder":
            for c in shape:
                if c.attrib.get("name") == "p1":
                    c.attrib["name"] = "p0"
                elif c.attrib.get("name") == "p2":
                    c.attrib["name"] = "p1"
    for b in root.iter("bsdf"):
        t = b.attrib.get("type")
        if t in ("microfacet", "phong", "ward"):
            damt = samt = 1.0
            for c in list(b):
                nm = c.attrib.get("name")
                if nm == "diffuseAmount":
                    damt = float(c.attrib["value"])
                    b.remove(c)
                elif nm == "specularAmount":
                    samt = float(c.attrib["value"])
                    b.remove(c)
            if damt != 1.0:
                _scale_reflectance(b, "diffuseReflectance", damt)
            if samt != 1.0:
                _scale_reflectance(b, "specularReflectance", samt)
        if t == "lambertian":
            b.attrib["type"] = "diffuse"
        elif t == "mirror":
            b.attrib["type"] = "conductor"
            ET.SubElement(b, "string", {"name": "material", "value": "Cr"})
        elif t == "roughmetal":
            b.attrib["type"] = "roughconductor"
            for c in b:
                if c.attrib.get("name") == "alphaB":
                    c.attrib["name"] = "alpha"
                elif c.attrib.get("name") == "ior":
                    c.attrib["name"] = "eta"
        elif t == "roughglass":
            b.attrib["type"] = "roughdielectric"
            for c in b:
                if c.attrib.get("name") == "alphaB":
                    c.attrib["name"] = "alpha"
        elif t == "microfacet":
            b.attrib["type"] = "roughplastic"
            for c in b:
                if c.attrib.get("name") == "alphaB":
                    c.attrib["name"] = "alpha"
        elif t == "composite":
            b.attrib["type"] = "mixturebsdf"
        elif t == "ward":
            for c in b:
                if c.attrib.get("name") == "alphaX":
                    c.attrib["name"] = "alphaU"
                elif c.attrib.get("name") == "alphaY":
                    c.attrib["name"] = "alphaV"
    for tex in root.iter("texture"):
        t = tex.attrib.get("type")
        if t in ("exrtexture", "ldrtexture"):
            tex.attrib["type"] = "bitmap"
        if t in ("checkerboard", "gridtexture"):
            for c in tex:
                if c.attrib.get("name") == "brightColor":
                    c.attrib["name"] = "color1"
                elif c.attrib.get("name") == "darkColor":
                    c.attrib["name"] = "color0"
    for el in root.iter():
        for c in el:
            if c.attrib.get("name") == "sizeMultiplier":
                c.attrib["name"] = "densityMultiplier"


def _upgrade_03_to_04(root):
    import xml.etree.ElementTree as ET
    for cam in root.iter("camera"):
        cam.tag = "sensor"
        if cam.attrib.get("type") == "perspective":
            axis = "smaller"
            for c in list(cam):
                if c.tag == "boolean" \
                        and c.attrib.get("name") == "mapSmallerSide":
                    if c.attrib.get("value") == "false":
                        axis = "larger"
                    cam.remove(c)
            ET.SubElement(cam, "string",
                          {"name": "fovAxis", "value": axis})
        for tf in cam:
            if tf.tag == "transform" \
                    and tf.attrib.get("name") == "toWorld":
                tf.insert(0, ET.Element("scale", {"x": "-1"}))
    for lum in root.iter("luminaire"):
        # upgrade_0.4.0.xsl:49 renames 'intensity' only for area/constant
        # (->radiance) and directional (->irradiance); point/spot keep it.
        ltype = lum.attrib.get("type")
        if ltype in ("area", "constant", "directional"):
            for c in lum:
                if c.attrib.get("name") == "intensity":
                    c.attrib["name"] = ("irradiance"
                                        if ltype == "directional"
                                        else "radiance")
        lum.tag = "emitter"
    for integ in root.iter("integrator"):
        if integ.attrib.get("type") == "errctrl":
            integ.attrib["type"] = "adaptive"
        for c in integ:
            if c.attrib.get("name") == "luminaireSamples":
                c.attrib["name"] = "emitterSamples"
    for smp in root.iter("sampler"):
        for c in smp:
            if c.attrib.get("name") == "depth":
                c.attrib["name"] = "dimension"
    for film in root.iter("film"):
        t = film.attrib.get("type")
        if t == "exrfilm":
            film.attrib["type"] = "hdrfilm"
        elif t == "pngfilm":
            film.attrib["type"] = "ldrfilm"
        for c in list(film):
            if c.tag == "boolean" and c.attrib.get("name") == "alpha":
                fmt = "rgba" if c.attrib.get("value") == "true" else "rgb"
                film.remove(c)
                ET.SubElement(film, "string",
                              {"name": "pixelFormat", "value": fmt})
    for el in root.iter():
        for c in el:
            nm = c.attrib.get("name")
            if nm == "focusDepth":
                c.attrib["name"] = "focusDistance"
            elif nm in ("intensityScale", "densityMultiplier"):
                c.attrib["name"] = "scale"


def _upgrade_04_to_05(root):
    for b in root.iter("bsdf"):
        if b.attrib.get("type") == "bump":
            b.attrib["type"] = "bumpmap"


def upgrade_to_current(root) -> bool:
    """Apply the upgrade chain in place; returns True if anything ran."""
    ver = _version_tuple(root.attrib.get("version", "0.6.0"))
    if ver >= (0, 6):
        return False
    if ver < (0, 3):
        _upgrade_pre03(root)
    if ver < (0, 4):
        _upgrade_03_to_04(root)
    if ver < (0, 5):
        _upgrade_04_to_05(root)
    root.attrib["version"] = "0.6.0"
    return True
