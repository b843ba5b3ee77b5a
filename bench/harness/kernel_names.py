"""Which CUDA kernels of a profiler trace belong to which hand-written
kernel: ``bench/metrics/kernel_names.json`` (data), by the program's kernel
name (its ``kernels/boundary.py`` name)."""
import json
import os

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "metrics", "kernel_names.json")


def names_of(kernel: str):
    with open(_PATH) as f:
        return json.load(f)[kernel]
