"""The port's import lint (``grapevine_tpu_torch/analysis/importlint.py``,
a copy of the reference's): its findings equal the reference's on the
same seeded sources, and the port's own tree is clean."""

from __future__ import annotations

from pathlib import Path

import pytest

from grapevine_tpu.analysis import importlint as ref
from grapevine_tpu_torch.analysis import importlint as port
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

SOURCES = {
    "clean": "import os\n\n\ndef f():\n    return os.sep\n",
    "unused_import": "import os\nimport sys\n\nprint(sys.argv)\n",
    "unused_from": "from os import path, sep\n\nprint(sep)\n",
    "unused_local": "def f():\n    x = 1\n    y = 2\n    return y\n",
    "underscore_local": "def f():\n    _x = 1\n    return 0\n",
    "bare_except": "def f():\n    try:\n        return 1\n    except:\n        return 2\n",
    "noqa": "import os  # noqa: F401\n",
    "syntax_error": "def f(:\n    pass\n",
    "locals_call": "def f():\n    x = 1\n    return locals()\n",
    "except_name": "def f():\n    try:\n        pass\n    except ValueError as e:\n"
                   "        return 0\n",
}


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_findings_equal_the_references(case):
    got = port.check_source(SOURCES[case], "x.py")
    assert got == ref.check_source(SOURCES[case], "x.py")
    assert bool(got) == (case in ("unused_import", "unused_from", "unused_local",
                                  "bare_except", "syntax_error", "except_name"))


def test_the_ports_tree_is_clean():
    assert port.check_tree(str(ROOT / "grapevine_tpu_torch")) == {}
    assert port.main([]) == 0  # the default root is the port's package
