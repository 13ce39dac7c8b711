"""Runners: how one kind of cell is built, warmed, timed and checked.  A
cell's file names its runner (``"runner": "<name>"`` ->
``runners/<name>.py``, whose ``run(spec)`` returns a
``perfbench.harness.Result``, or a subclass that adds what its metrics
read)."""
import importlib


def runner(name: str):
    return importlib.import_module(f"perfbench.runners.{name}")
