"""What entry points rely on: the compile-cache helper, importing the
package without PyYAML, and float32 contractions pinned to HIGHEST."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code, **env_over):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_over)
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_honours_env(tmp_path):
    target = str(tmp_path / "cc")
    proc = _child(
        "import jax; from groan_rs_tpu.compile_cache import "
        "enable_compile_cache as e; p = e(); "
        "print(p); print(jax.config.jax_compilation_cache_dir)",
        JAX_COMPILATION_CACHE_DIR=target)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [target, target]
    assert os.path.isdir(target)


def test_compile_cache_default_is_fixed_inside_checkout():
    proc = _child(
        "import jax; from groan_rs_tpu.compile_cache import "
        "enable_compile_cache as e; p = e(); "
        "print(p); print(jax.config.jax_compilation_cache_dir)")
    assert proc.returncode == 0, proc.stderr
    want = os.path.join(ROOT, ".jax_cache")
    assert proc.stdout.split() == [want, want]
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_importing_the_library_sets_no_cache():
    proc = _child("import jax, groan_rs_tpu; "
                  "print(jax.config.jax_compilation_cache_dir)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() in ("None", "")


def test_import_without_yaml():
    """The package and its default element table load with `yaml`
    unimportable; a YAML element file then fails with a clear error."""
    proc = _child(
        "import sys; sys.modules['yaml'] = None\n"
        "import groan_rs_tpu\n"
        "from groan_rs_tpu.core.elements import Elements\n"
        "from groan_rs_tpu.errors import ElementError\n"
        "e = Elements.default(); print(len(e.names()))\n"
        "import tempfile, os\n"
        "p = os.path.join(tempfile.mkdtemp(), 'e.yaml')\n"
        "open(p, 'w').write('carbon:\\n  mass: 12.0\\n')\n"
        "try:\n"
        "    Elements.from_file(p)\n"
        "except ElementError as err:\n"
        "    print('PyYAML' in str(err))\n",
        JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["39", "True"]


def test_default_elements_match_json_table():
    import json

    from groan_rs_tpu.core.elements import _DEFAULT_DB, Elements

    with open(_DEFAULT_DB) as fh:
        raw = json.load(fh)
    e = Elements.default()
    assert e.names() == list(raw)
    assert e.get("carbon").mass == pytest.approx(12.0107)
    assert e.get("hydrogen").symbol == "H"


def test_json_element_file_merges(tmp_path):
    from groan_rs_tpu.core.elements import Elements

    p = tmp_path / "extra.json"
    p.write_text('{"carbon": {"mass": 13.0}, "xenon": {"symbol": "Xe"}}')
    e = Elements.default()
    e.update(Elements.from_file(str(p)))
    assert e.get("carbon").mass == 13.0
    assert e.get("xenon").symbol == "Xe"


def _dot_precisions(fn, *args):
    """The `precision` of every dot_general in fn's jaxpr, nested ones
    included."""
    import jax

    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


@pytest.mark.parametrize("name", ["kabsch", "center_triclinic",
                                  "min_image_triclinic", "rotate"])
def test_f32_contractions_pin_highest(name):
    """Every float32 contraction on these paths asks for HIGHEST, so a
    TF32 default cannot enter."""
    import jax

    from groan_rs_tpu.ops import center, pbc, rmsd, vecmath

    rng = np.random.default_rng(0)
    p = rng.random((2, 16, 3)).astype(np.float32)
    h = (np.eye(3, dtype=np.float32) * 4.0)[None].repeat(2, 0)
    fns = {
        "kabsch": lambda: _dot_precisions(
            lambda a, b: rmsd.kabsch(a, b, np.ones(16, np.float32),
                                     a.mean(-2), b.mean(-2)), p, p[::-1]),
        "center_triclinic": lambda: _dot_precisions(
            center.center_triclinic, p, h),
        "min_image_triclinic": lambda: _dot_precisions(
            pbc.min_image_triclinic, p[0], h[0]),
        "rotate": lambda: _dot_precisions(
            vecmath.rotate, p[0], np.eye(3, dtype=np.float32)),
    }
    precs = fns[name]()
    assert precs, "no contraction traced"
    hi = jax.lax.Precision.HIGHEST
    for pr in precs:
        assert pr is not None and all(x == hi for x in pr), pr
