#!/usr/bin/env python3
"""Runs ``scripts/make_adhoc_fixture.py``, unchanged and with the same
arguments, where another installed package owns the top-level name
``tests``.

The generator imports ``tests.indri_fixture``, and this checkout's
``tests/`` has no ``__init__.py``: a regular package named ``tests``
anywhere on ``sys.path`` (some distributions install one) wins over it.
This launcher names the checkout's ``tests/`` as that package first.

    python3 scripts/make_adhoc_fixture_torch.py --root build/adhoc \\
        --num_docs 65536 --num_indexes 4
"""

import os
import runpy
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tests = types.ModuleType("tests")
    tests.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = tests
    sys.argv[0] = os.path.join(REPO, "scripts", "make_adhoc_fixture.py")
    runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
