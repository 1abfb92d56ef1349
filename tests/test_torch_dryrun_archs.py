"""The other half of the archs at ``--reduced`` on the (2, 2, 2) test
mesh through the port's dry-run CLI, in a process of its own: every
(arch x shape) cell ``ok`` or the reference's ``applicable`` skip
(``tests/test_torch_dryrun.py`` runs the first half)."""

import pytest

from test_torch_dryrun import ARCHS as FIRST, check_cells, run_reduced
from repro.configs import ARCH_IDS

ARCHS = tuple(a for a in ARCH_IDS if a not in FIRST)


@pytest.fixture(scope="module")
def reduced_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return out, run_reduced(out, ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_run_or_skip(reduced_run, arch):
    out, proc = reduced_run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    check_cells(out, [arch])
