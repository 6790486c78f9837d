"""The port stands alone: every ``nebula_tpu_torch`` module imports with
jax and msgpack blocked and loads nothing of the JAX package, and
``chip_smoke.py`` neither imports the reference nor runs without a CUDA
card."""
import ast
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any jax import now fails
sys.modules["msgpack"] = None        # the expression codec is the port's
import nebula_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    nebula_tpu_torch.__path__, "nebula_tpu_torch."))
for name in names:
    importlib.import_module(name)
ref = sorted(k for k in sys.modules
             if k == "nebula_tpu" or k.startswith("nebula_tpu."))
from nebula_tpu_torch.filter.expressions import (decode_expr, encode_expr,
                                                 PrimaryExpr)
assert str(decode_expr(encode_expr(PrimaryExpr(5)))) == "5"
jax = sorted(k for k in sys.modules
             if (k == "jax" or k.startswith("jax.")) and sys.modules[k])
import json, threading
print(json.dumps({"modules": names, "ref": ref, "jax": jax,
                  "threads": threading.active_count()}))
"""


def _run(code, cwd=ROOT):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax_or_reference():
    res = _run(_PROBE)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("nebula_tpu_torch.tpu.runtime", "nebula_tpu_torch.tpu.ell_ops",
                 "nebula_tpu_torch.graph.batch_dispatch",
                 "nebula_tpu_torch.tools.graphgen",
                 "nebula_tpu_torch.tpu.edge_ops",
                 "nebula_tpu_torch.tpu.expr_compile",
                 "nebula_tpu_torch.tpu.expr_program",
                 "nebula_tpu_torch.filter.expressions",
                 "nebula_tpu_torch.filter.functions",
                 "nebula_tpu_torch.filter.wire",
                 "nebula_tpu_torch.graph.interim",
                 "nebula_tpu_torch.interface.common",
                 "nebula_tpu_torch.meta.schema"):
        assert name in out["modules"]
    assert out["ref"] == [], f"reference modules loaded: {out['ref']}"
    assert out["jax"] == [], f"jax modules loaded: {out['jax']}"
    # importing starts no thread (a pump starts with its stream)
    assert out["threads"] == 1


def test_prefix_check_tells_port_from_reference():
    """The probe's filter must not count the port's own prefix as the
    reference's: nebula_tpu_torch.* is not nebula_tpu.*."""
    mods = ["nebula_tpu_torch", "nebula_tpu_torch.tpu.ell", "nebula_tpu",
            "nebula_tpu.tpu.ell"]
    hits = [k for k in mods if k == "nebula_tpu" or k.startswith("nebula_tpu.")]
    assert hits == ["nebula_tpu", "nebula_tpu.tpu.ell"]


def _imported_roots(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


def test_port_sources_name_no_reference_import():
    bad = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, fs in os.walk(os.path.join(ROOT, "nebula_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        for mod in _imported_roots(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "nebula_tpu", "msgpack"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a visible card the smoke run exits non-zero and prints no
    result; alone in a directory (no package beside it) it fails too."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""     # hide any card, here or not
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
