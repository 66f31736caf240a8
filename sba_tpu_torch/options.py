"""Option registry: dot-namespaced CLI flags.

Port of ``sba_tpu/options.py`` (a host-only module, kept here as the
port's own copy so that the port imports nothing of ``sba_tpu``): the
flags and the project.ini round-trip.

Capability parity with ref: src/util/option_manager.{h,cc}
(`OptionManager` option_manager.h:90-141): every module contributes a
dataclass of defaults; CLI flags are dot-namespaced
(`--SemanticBundleAdjustment.depth_error_threshold 1.5`, ref:
option_manager.cc:509-514).

Instead of boost::program_options, options ARE the dataclasses already
defined next to each subsystem (SiftExtractionOptions, BAOptions,
SBAOptions, ...) — this module maps flag strings onto those dataclasses
generically, so defaults live in exactly one place.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _coerce(value: str, target):
    """Parse a flag string into the type of the dataclass default."""
    if isinstance(target, bool):
        v = value.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {value!r}")
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if target is None or isinstance(target, str):
        return value
    raise ValueError(f"unsupported option type {type(target)}")


def parse_flags(argv: Sequence[str]) -> Tuple[Dict[str, str], List[str]]:
    """Split argv into {--key: value} flags and positional args.
    Accepts `--key value` and `--key=value` (the reference's boost
    parser accepts both)."""
    flags: Dict[str, str] = {}
    positional: List[str] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                flags[k] = v
            elif a == "--help":
                flags["help"] = "1"     # value-less, like boost's -h
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"flag {a} missing value")
                flags[a[2:]] = argv[i + 1]
                i += 1
        else:
            positional.append(a)
        i += 1
    return flags, positional


def apply_flags(obj: Any, section: str, flags: Dict[str, str],
                consumed: Optional[set] = None) -> Any:
    """Apply `--Section.field value` flags onto a (frozen or mutable)
    dataclass instance; returns the updated instance."""
    updates = {}
    for key, value in flags.items():
        if "." not in key:
            continue
        sec, field_name = key.split(".", 1)
        if sec != section:
            continue
        if not hasattr(obj, field_name):
            raise ValueError(
                f"unknown option --{section}.{field_name}")
        updates[field_name] = _coerce(value, getattr(obj, field_name))
        if consumed is not None:
            consumed.add(key)
    if not updates:
        return obj
    if dataclasses.is_dataclass(obj):
        try:
            return dataclasses.replace(obj, **updates)
        except TypeError:
            pass  # frozen=False dataclass with field issues -> setattr
    for k, v in updates.items():
        setattr(obj, k, v)
    return obj


def write_project_ini(path: str, sections: Dict[str, Any],
                      top_level: Optional[Dict[str, str]] = None):
    """Write a project.ini (ref: option_manager.cc:1095 Write)."""
    cp = configparser.ConfigParser()
    cp.optionxform = str  # preserve case
    if top_level:
        cp["DEFAULT"] = {k: str(v) for k, v in top_level.items()}
    for name, obj in sections.items():
        if dataclasses.is_dataclass(obj):
            cp[name] = {
                f.name: str(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name),
                              (bool, int, float, str))}
        else:
            cp[name] = {k: str(v) for k, v in vars(obj).items()
                        if isinstance(v, (bool, int, float, str))}
    with open(path, "w") as f:
        cp.write(f)


def read_project_ini(path: str) -> Dict[str, Dict[str, str]]:
    """Read a project.ini into {section: {key: value}}
    (ref: option_manager.cc:1018 Read)."""
    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read(path)
    out: Dict[str, Dict[str, str]] = {}
    for sec in cp.sections():
        out[sec] = dict(cp[sec])
    if cp.defaults():
        out["DEFAULT"] = dict(cp.defaults())
    return out


def flags_from_ini(ini: Dict[str, Dict[str, str]]) -> Dict[str, str]:
    """Flatten ini sections back into dot-namespaced flags."""
    flags = {}
    for sec, kv in ini.items():
        if sec == "DEFAULT":
            flags.update(kv)
        else:
            for k, v in kv.items():
                flags[f"{sec}.{k}"] = v
    return flags
