"""The port stands alone: no jax, nothing of the JAX package.

Every module of ``src/repro_torch/`` and ``chip_smoke.py`` is read as a
syntax tree: an ``import``/``from`` of ``jax`` or ``repro`` (as opposed to
``repro_torch``) fails, and so does a string literal naming a ``repro.``
module, the way ``importlib.import_module("repro.remote.bnlj")`` would.
Then a fresh interpreter with both packages blocked imports every port
module, runs a tiny Session on the port's CPU backend and serves a reduced
gemma-2b and a reduced mamba2-370m through ``ServeEngine.submit`` on the CPU.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "repro")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _violations(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in BLOCKED:
                yield f"{path.name}:{node.lineno} imports {name}"
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("repro.")):
            yield f"{path.name}:{node.lineno} names {node.value!r}"


def test_files_to_check_exist():
    assert (PORT / "remote" / "backend.py") in FILES
    assert (PORT / "models" / "ssm.py") in FILES
    assert {"ssd_scan.py", "ops.py", "ref.py"} <= {
        p.name for p in FILES if p.parent.name == "ssd_scan"}
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(FILES) >= 25


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert list(_violations(path)) == []


def test_checker_catches_what_it_should(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import jax.numpy as jnp
        from repro.core import TABLE_I
        import importlib
        importlib.import_module("repro.remote.bnlj")
        from repro_torch.core import TABLE_I as fine
    """))
    found = list(_violations(bad))
    assert len(found) == 3, found


def test_port_imports_and_runs_with_jax_package_blocked():
    modules = list(_port_modules())
    script = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for name in {modules!r}:
            importlib.import_module(name)
        from repro_torch.engine import Session, WorkloadStats
        from repro_torch.remote import make_backend
        from repro_torch.remote.simulator import make_key_pages, make_relation
        backend = make_backend(("dram", 8), "ssd", device="cpu")
        sess = Session(backend, budget=12.0, eviction="lru")
        ids = make_key_pages(backend, 12, 4, seed=1)
        build = make_relation(backend, 16, 4, 8, seed=2)
        probe = make_relation(backend, 32, 4, 8, seed=3)
        res = sess.run([
            sess.task("ems", WorkloadStats(size_r=12, k_cap=4),
                      inputs={{"page_ids": ids}}, rows_per_page=4),
            sess.task("ehj", WorkloadStats(size_r=4, size_s=8, out=4,
                                           partitions=4, sigma=0.5),
                      inputs={{"build": build, "probe": probe}}),
        ], replan="measured")
        assert backend.wall.kernel_calls > 0 and backend.wall.kernel_fallbacks == 0
        import numpy as np
        from repro_torch.configs import ARCHS, reduced
        from repro_torch.models import transformer as tf
        from repro_torch.runtime.serve_loop import Request, ServeEngine
        for arch, lens in (("gemma-2b", (5, 6, 7)), ("mamba2-370m", (64, 7, 32))):
            cfg = reduced(ARCHS[arch])
            engine = ServeEngine(cfg, tf.init_params(cfg, device="cpu"), max_len=80,
                                 batch_slots=2, device="cpu")
            served = engine.submit([Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                                            max_new_tokens=4) for i, n in enumerate(lens)])
            assert sorted(served) == [0, 1, 2] and all(len(t) == 4 for t in served.values())
        leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                        and m.split(".")[0] in ("jax", "repro"))
        assert not leaked, leaked
        print("ok", len({modules!r}), res.total.c_total)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
