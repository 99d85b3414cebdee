"""Reflection-driven property table: the headless ``PropertyTable``.

Port of ``syzygy_tpu/app/properties.py``. The reference edits every scene
parameter live through a 3-column (name / value / reset-to-default) table
(``ui/propertytable.hpp:28-226``) filled by the scene-controls window
(``ui/statelesswidgets.cpp:165-377``), with defaults from ``Scene``'s
static members (``renderer/scene.cpp:52-91``) and instance transforms
resetting to their spawn ("original") values.

:func:`discover` enumerates every editable field of the cameras,
atmosphere, sun animation, spotlights and mesh instances with its current
value and reset default; :func:`get_path`/:func:`set_path`/
:func:`reset_path` edit one by dotted path (``camera.fov_degrees``,
``spotlights[0].strength``, ``geometry[1].transforms[0].translation``;
``camera`` is the active camera). :func:`apply_config_field` edits a
``RenderConfig`` field by its reflected type.

Unlike the reference, an int field refuses a float that is not integral
(the reference truncates it), and :func:`apply_config_field` validates the
whole new config (``RenderConfig.check``) before it returns it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import re
from typing import Any, NamedTuple

import numpy as np

from syzygy_tpu_torch.scene.atmosphere import Atmosphere, SunAnimation
from syzygy_tpu_torch.scene.camera import Camera
from syzygy_tpu_torch.scene.lights import SpotlightParams
from syzygy_tpu_torch.scene.scene import Scene


class Property(NamedTuple):
    path: str
    value: Any
    default: Any  # None only when no reset target exists


# Scene-level scalar fields the table exposes (defaults from the Scene
# dataclass itself; geometry/cameras/spotlights are expanded per element).
_SCENE_SCALARS = ("camera_index", "camera_speed", "render_atmosphere", "spotlights_render")


def _dataclass_default(cls, name):
    for f in dataclasses.fields(cls):
        if f.name != name:
            continue
        if f.default is not dataclasses.MISSING:
            return f.default
        if f.default_factory is not dataclasses.MISSING:
            return f.default_factory()
    return None


def _expand_dataclass(prefix: str, obj, defaults_obj) -> list[Property]:
    return [
        Property(f"{prefix}.{f.name}", getattr(obj, f.name), getattr(defaults_obj, f.name))
        for f in dataclasses.fields(obj)
    ]


def discover(scene: Scene) -> list[Property]:
    """Every editable property with its reset default, in the order of the
    reference's scene-controls window (``ui/statelesswidgets.cpp:752-833``).
    Transform rows reset to the instance's originals."""
    props = [Property(name, getattr(scene, name), _dataclass_default(Scene, name)) for name in _SCENE_SCALARS]
    props += _expand_dataclass("sun_animation", scene.sun_animation, SunAnimation())
    props += _expand_dataclass("atmosphere", scene.atmosphere, Atmosphere())
    for i, cam in enumerate(scene.cameras):
        props += _expand_dataclass(f"cameras[{i}]", cam, Camera())
    for i, spot in enumerate(scene.spotlights):
        props += _expand_dataclass(f"spotlights[{i}]", spot, SpotlightParams())
    for i, inst in enumerate(scene.geometry):
        g = f"geometry[{i}]"
        props.append(Property(f"{g}.render", inst.render, True))
        props.append(Property(f"{g}.casts_shadow", inst.casts_shadow, True))
        props.append(Property(f"{g}.animation", inst.animation, inst.animation))
        for j, (t, orig) in enumerate(zip(inst.transforms, inst.originals)):
            p = f"{g}.transforms[{j}]"
            props.append(Property(f"{p}.translation", t.translation, orig.translation))
            props.append(Property(f"{p}.euler_angles", t.euler_angles, orig.euler_angles))
            props.append(Property(f"{p}.scale", t.scale, orig.scale))
    return props


def _fmt(v) -> str:
    if isinstance(v, enum.Enum):
        return v.name
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, np.ndarray):
        return "(" + ", ".join(f"{float(x):.6g}" for x in v.reshape(-1)) + ")"
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(_fmt(x) for x in v) + ")"
    return str(v)


def format_table(props: list[Property]) -> str:
    """The 3-column name / value / reset-default render; ``*`` marks a
    value away from its default."""
    rows = [(p.path, _fmt(p.value), _fmt(p.default)) for p in props]
    w0 = max((len(r[0]) for r in rows), default=4)
    w1 = max((len(r[1]) for r in rows), default=5)
    lines = [f"{'property':<{w0}}  {'value':<{w1}}  default"]
    lines.append("-" * len(lines[0]))
    for r in rows:
        star = "" if r[1] == r[2] else " *"
        lines.append(f"{r[0]:<{w0}}  {r[1]:<{w1}}  {r[2]}{star}")
    return "\n".join(lines)


_PATH_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)(?:\[(\d+)\])?")


def _resolve(scene: Scene, path: str):
    """Walk a dotted/indexed path -> (container, attribute) of the leaf."""
    parts = path.split(".")
    obj: Any = scene
    for k, part in enumerate(parts):
        m = _PATH_RE.fullmatch(part)
        if not m:
            raise KeyError(f"bad path segment {part!r} in {path!r}")
        name, idx = m.group(1), m.group(2)
        last = k == len(parts) - 1
        if last and idx is None:
            return obj, name
        child = getattr(obj, name)
        if idx is not None:
            child = child[int(idx)]
            if last:
                raise KeyError(f"{path!r} names an object, not a property")
        obj = child
    raise KeyError(path)


def get_path(scene: Scene, path: str):
    obj, attr = _resolve(scene, path)
    return getattr(obj, attr)


def _as_int(value) -> int:
    """An int from an int, an integral float or a numeric string; a float
    with a fractional part is refused, not truncated."""
    if isinstance(value, float) and not value.is_integer():
        raise ValueError(f"expected an integer, got {value!r}")
    return int(value)


def _coerce(current, value):
    """A parsed value coerced to the field's current type."""
    if isinstance(current, enum.Enum):
        if isinstance(value, str):
            return type(current)[value]
        return type(current)(value)
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int):
        return _as_int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        seq = value if isinstance(value, (list, tuple)) else [value]
        if len(seq) != len(current):
            raise ValueError(f"expected {len(current)} components, got {len(seq)}")
        return tuple(float(x) for x in seq)
    if isinstance(current, np.ndarray):
        arr = np.asarray(value, current.dtype)
        if arr.shape != current.shape:
            raise ValueError(f"expected shape {current.shape}, got {arr.shape}")
        return arr
    return value


def set_path(scene: Scene, path: str, value) -> None:
    """Set one property. Transform fields are views into the instance's
    SoA blocks and are written through ``[:]``, so the packed per-frame
    path sees the edit."""
    obj, attr = _resolve(scene, path)
    current = getattr(obj, attr)
    new = _coerce(current, value)
    if isinstance(current, np.ndarray):
        current[:] = new
    else:
        setattr(obj, attr, new)


def reset_path(scene: Scene, path: str) -> None:
    """Reset one property to its discovered default."""
    for p in discover(scene):
        if p.path == path:
            set_path(scene, path, p.default)
            return
    raise KeyError(f"unknown property {path!r}")


def canonical_path(scene: Scene, path: str) -> str:
    """Expand the ``camera.`` alias to the active camera's indexed path."""
    if path.startswith("camera."):
        return f"cameras[{scene.camera_index}].{path[len('camera.'):]}"
    return path


def parse_value(text: str):
    """CLI value parser: JSON first (numbers, bools, lists), else string."""
    try:
        return json.loads(text)
    except ValueError:
        return text


def apply_set(scene: Scene, spec: str) -> str:
    """Apply one ``--set path=value`` spec; value ``default`` resets.
    Returns the canonical path."""
    if "=" not in spec:
        raise ValueError(f"--set expects path=value, got {spec!r}")
    path, _, text = spec.partition("=")
    path = canonical_path(scene, path.strip())
    if text.strip() == "default":
        reset_path(scene, path)
    else:
        set_path(scene, path, parse_value(text.strip()))
    return path


def apply_config_field(config, name: str, value):
    """One ``RenderConfig`` field edited by its reflected type (the
    pipeline editor's coercion, ``ui/pipelineui.cpp:43-424``): ``value`` is
    a string (JSON-parsed; ``"default"`` resets to the dataclass default)
    or a typed value. Returns the new config, validated as a whole
    (``RenderConfig.check``) before it is returned; the old one is
    untouched. Shared by the viewer's ``config.*`` rows and the CLI's
    ``--set config.*``."""
    fields = {f.name: f for f in dataclasses.fields(type(config))}
    if name not in fields:
        raise KeyError(f"no RenderConfig field {name!r}")
    fld = fields[name]
    if isinstance(value, str) and value.strip() == "default":
        value = fld.default
    else:
        if isinstance(value, str):
            value = parse_value(value)
        want = type(fld.default)
        if want is bool:
            if isinstance(value, str):  # "False"/"off" must not be truthy
                value = value.strip().lower() in ("1", "true", "on", "yes")
            value = bool(value)
        elif want is int:
            value = _as_int(value)
        elif want is float:
            value = float(value)
        elif want is str:
            value = str(value)
    new = dataclasses.replace(config, **{name: value})
    new.check()
    return new
