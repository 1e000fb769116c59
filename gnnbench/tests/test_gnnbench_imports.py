"""The benchmark measures ignnition_tpu_torch alone: no module under
gnnbench/ imports jax, jaxlib, flax or the JAX package (top-level names
compared whole: ignnition_tpu_torch is not ignnition_tpu), the references
import nothing of the program, and a dry run of the traffic and the
references leaves none of them in sys.modules."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ignnition_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_sources(path):
    assert not FORBIDDEN.intersection(imported_tops(path))


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "ignnition_tpu_torch" not in tops and "gnnbench" not in tops


def test_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import ignnition_tpu_torch.ops\nfrom ignnition_tpu_torch import build\n")
    assert not FORBIDDEN.intersection(imported_tops(f))
    f.write_text("from ignnition_tpu.data import x\n")
    assert FORBIDDEN.intersection(imported_tops(f)) == {"ignnition_tpu"}


DRY_RUN = """
import sys, torch
sys.path.insert(0, {root!r})
from gnnbench import generate, harness
for cell in ("routenet_x4_train", "routenet_train"):
    c = harness.load_cell(cell)
    c.mix = generate.family(c.mix).small(c.mix)
    raws = [generate.batch(c.mix, 7, i) for i in range(3)]
    spec = harness.modules("reference", c.config).param_spec(c.config)
    w = {{k: torch.full(s, 0.01) for k, (s, _) in spec.items()}}
    harness.reference_side(c, raws, w, torch.device("cpu"))
    harness.reference_side(c, raws, w, torch.device("cpu"), rounding="control")
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_dry_run_loads_no_jax_and_no_program():
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(HERE.parent))],
                         capture_output=True, text=True, timeout=300, check=True)
    tops = set(out.stdout.split())
    assert "gnnbench" in tops and "torch" in tops
    assert not FORBIDDEN.intersection(tops) and "ignnition_tpu_torch" not in tops
