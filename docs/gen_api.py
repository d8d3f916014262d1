"""Generate docs/API.md — the public-surface index (one line per symbol).

Run from the repo root: python docs/gen_api.py
"""

try:
    import aether_primitives_tpu  # noqa: F401
except ModuleNotFoundError:  # bare offline clone: resolve the in-tree package
    import os as _os
    import sys as _sys

    _sys.path.append(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import importlib
import inspect
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "aether_primitives_tpu",
    "aether_primitives_tpu.types",
    "aether_primitives_tpu.evm",
    "aether_primitives_tpu.boundary",
    "aether_primitives_tpu.ops.vecops",
    "aether_primitives_tpu.ops.fft",
    "aether_primitives_tpu.ops.fir",
    "aether_primitives_tpu.ops.firdes",
    "aether_primitives_tpu.ops.sampling",
    "aether_primitives_tpu.ops.modulation",
    "aether_primitives_tpu.ops.sequence",
    "aether_primitives_tpu.ops.noise",
    "aether_primitives_tpu.ops.frontend",
    "aether_primitives_tpu.ops.analog",
    "aether_primitives_tpu.ops.fec",
    "aether_primitives_tpu.ops.ldpc",
    "aether_primitives_tpu.ops.nr_ldpc",
    "aether_primitives_tpu.ops.rs",
    "aether_primitives_tpu.ops.bch",
    "aether_primitives_tpu.ops.tpc",
    "aether_primitives_tpu.ops.turbo",
    "aether_primitives_tpu.ops.polar",
    "aether_primitives_tpu.ops.iir",
    "aether_primitives_tpu.models.modem",
    "aether_primitives_tpu.models.channelizer",
    "aether_primitives_tpu.models.ddc",
    "aether_primitives_tpu.models.sync",
    "aether_primitives_tpu.models.equalizer",
    "aether_primitives_tpu.models.ofdm",
    "aether_primitives_tpu.models.fsk",
    "aether_primitives_tpu.models.css",
    "aether_primitives_tpu.models.packet",
    "aether_primitives_tpu.models.caf",
    "aether_primitives_tpu.models.amc",
    "aether_primitives_tpu.models.diversity",
    "aether_primitives_tpu.models.fhss",
    "aether_primitives_tpu.models.channel",
    "aether_primitives_tpu.models.detect",
    "aether_primitives_tpu.models.ber",
    "aether_primitives_tpu.parallel.mesh",
    "aether_primitives_tpu.parallel.halo",
    "aether_primitives_tpu.parallel.streaming",
    "aether_primitives_tpu.utils.db",
    "aether_primitives_tpu.utils.file",
    "aether_primitives_tpu.utils.plot",
    "aether_primitives_tpu.utils.metrics",
    "aether_primitives_tpu.utils.profiling",
    "aether_primitives_tpu.native",
    "aether_primitives_tpu.cli",
]


def first_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    line = doc.split("\n", 1)[0].strip()
    return line


def public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    for n in sorted(names):
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            if getattr(obj, "__module__", "").startswith("aether_primitives_tpu"):
                yield n, obj
        elif not callable(obj) and n.isupper():  # constants / tables
            yield n, obj


def main():
    out = [
        "# API reference",
        "",
        "Public surface of `aether_primitives_tpu`, one line per symbol.",
        "Regenerate with `python docs/gen_api.py` after adding API.",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        rows = []
        for name, obj in public_members(mod):
            if inspect.isclass(obj):
                rows.append(f"- **`{name}`** (class) — {first_line(obj)}")
                for mname, meth in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(meth):
                        continue
                    fl = first_line(meth)
                    if fl:
                        rows.append(f"  - `.{mname}()` — {fl}")
            elif inspect.isfunction(obj):
                try:
                    sig = str(inspect.signature(obj))
                except (TypeError, ValueError):
                    sig = "(...)"
                if len(sig) > 70:
                    sig = "(...)"
                rows.append(f"- `{name}{sig}` — {first_line(obj)}")
            else:
                rows.append(f"- `{name}` — constant")
        if rows:
            out.append(f"## `{modname}`")
            head = first_line(mod)
            if head:
                out.append(f"\n{head}\n")
            out.extend(rows)
            out.append("")
    path = Path(__file__).parent / "API.md"
    path.write_text("\n".join(out) + "\n")
    print(f"wrote {path} ({len(out)} lines)")


if __name__ == "__main__":
    sys.exit(main())
