"""A scene given as data: named materials and polygons, as a
configuration's ``builder_args`` lists them."""

from __future__ import annotations

from .assemble import Arrays, Assembler


def build(*, materials: dict, polygons: list) -> Arrays:
    """``materials``: name -> {Ka, Kd, Ks, Ns, Tr, Ni} (missing keys take
    the default); ``polygons``: [{"group", "material", "corners"}]."""
    b = Assembler()
    ids = {name: b.material(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in m.items()})
           for name, m in materials.items()}
    for p in polygons:
        b.polygon(p["group"], ids[p["material"]], p["corners"])
    return b.arrays()
