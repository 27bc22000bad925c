"""The port has every public name of the JAX package, except those it does
not port: a walk of both packages' sources (top-level functions and
classes, and the classes' public methods) finds no other JAX name that the
port lacks.

Not ported, and only TPU-specific code (ROADMAP "Do not port"): the
Pallas module ``ops/pallas_banded`` (its kernel is
``csrc/banded_solve.cu``), the TPU backend crossover
``parallel/batch.backend_for``, the TPU compile cache and host pinning of
``utils/device`` and ``utils/log``.
"""
import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = ("ops/pallas_banded.", "parallel/batch.backend_for",
              "utils/device.enable_compile_cache", "utils/device.host_cpu",
              "utils/log.")


def public_names(package: str) -> set:
    root = os.path.join(REPO, package)
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, "/")
            mod = mod[:-len("/__init__")] if mod.endswith("/__init__") \
                else mod
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                        or node.name.startswith("_"):
                    continue
                out.add(f"{mod}.{node.name}")
                if isinstance(node, ast.ClassDef):
                    out.update(f"{mod}.{node.name}.{m.name}"
                               for m in node.body
                               if isinstance(m, ast.FunctionDef)
                               and not m.name.startswith("_"))
    return out


def test_port_has_every_public_jax_name():
    jax_names = public_names("cheetah_pose_estimation_tpu")
    port_names = public_names("cheetah_pose_estimation_tpu_torch")
    missing = sorted(n for n in jax_names - port_names
                     if not n.startswith(NOT_PORTED))
    assert not missing, missing
    # the exclusions name what is there to exclude
    for prefix in NOT_PORTED:
        assert any(n.startswith(prefix) for n in jax_names), prefix
        assert not any(n.startswith(prefix) for n in port_names), prefix
    assert "native.load_tables" in port_names
    assert "parallel/batch.dryrun_multichip" in port_names
    assert "data/io.load_pandas_h5" in port_names
    assert "pipeline/grf_parity.grf_parity" in port_names
