"""The notebook-form deliverables must execute cleanly end-to-end.

Reference parity: the reference ships analysis notebooks
(Kan_model_analysis.ipynb, Sparsity_check/check_sparsity_ofJSData.ipynb);
ours live in notebooks/ with the same flows (script twins in examples/).
A notebook that only renders is documentation; these run in a real
ipykernel so a drifted API breaks the suite, not the reader.
"""

import os
import pathlib

import nbformat
import pytest
from nbclient import NotebookClient

NOTEBOOKS = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "notebooks").glob(
        "*.ipynb"
    )
)


def test_notebooks_exist():
    names = {p.name for p in NOTEBOOKS}
    assert "kan_model_analysis.ipynb" in names
    assert "check_sparsity_market_data.ipynb" in names


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.stem)
def test_notebook_executes(path):
    # the kernel is a fresh subprocess: it sees os.environ, not this
    # process's jax config, so pin CPU the env-var way
    os.environ["JAX_PLATFORMS"] = "cpu"
    nb = nbformat.read(path, as_version=4)
    client = NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": str(path.parent.parent)}},
    )
    client.execute()  # raises CellExecutionError on any failing cell
    executed = [c for c in nb.cells if c.cell_type == "code"]
    assert executed and all(c.execution_count for c in executed)
