#!/usr/bin/env python3
"""The port's `cuda`-marked tests, on a GPU machine that has no JAX.

    python3 scripts/torch_cuda_tests.py [pytest arguments]   # default: tests/test_torch_*.py

The test files import JAX and the JAX package at module level, for their
CPU comparisons with the reference; the tests marked `cuda` use neither.
This runs pytest with `-m cuda` and without `tests/conftest.py` (which sets
JAX up), each module of jax, jaxlib, flax, optax, orbax, grain (the
reference's loader) and mvropose_tpu standing in as an empty package whose every attribute is a MagicMock (and
`dataclasses.replace` of such a MagicMock giving another, for the
reference's configurations that the files derive at module level). Needs a
CUDA GPU: without one the tests skip.
"""

from __future__ import annotations

import dataclasses
import importlib.abc
import importlib.machinery
import sys
import types
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[1]
STUBBED = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "mvropose_tpu")


class Stub(types.ModuleType):
    """A package whose attributes are MagicMocks, made on first use."""

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        value = mock.MagicMock(name=f"{self.__name__}.{name}")
        setattr(self, name, value)
        return value


class StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds a Stub for every module under STUBBED."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] not in STUBBED:
            return None
        return importlib.machinery.ModuleSpec(name, self, is_package=True)

    def create_module(self, spec):
        return Stub(spec.name)

    def exec_module(self, module) -> None:
        pass


def replace(obj, /, **changes):
    """`dataclasses.replace`, which gives a MagicMock another."""
    if isinstance(obj, mock.Mock):
        return mock.MagicMock(name=f"{obj._extract_mock_name()}.replaced")
    return REPLACE(obj, **changes)


REPLACE = dataclasses.replace


def main() -> int:
    sys.meta_path.insert(0, StubFinder())
    dataclasses.replace = replace
    sys.path.insert(0, str(ROOT))
    args = sys.argv[1:] or sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py"))
    return int(pytest.main(["--noconftest", "-p", "no:cacheprovider", "-m", "cuda",
                            "--rootdir", str(ROOT), *args]))


if __name__ == "__main__":
    sys.exit(main())
