"""Benchmark harness: registry, subprocess isolation, regex filtering.

Capability parity with the reference harness
(``/root/reference/benchmark/benchmark.py:37-247``): benchmarks register
under templated names over a parameter product; each selected case runs in a
*fresh child process* (isolation against allocator/compilation-cache state —
the reference used a fork + named FIFO for the same reason; here the child
reports one JSON line over stdout); results print as a table or CSV.

Usage pattern (see bench_roberta.py):

    from benchmark.harness import Benchmark, main

    class MyBench(Benchmark):
        name = "Model/{variant}/{batch}"
        params = {"variant": ["Baseline", "Quantized"], "batch": [64, 128]}

        def run(self, variant, batch):        # executed in the child
            return {"time_s": ..., "mem_bytes": ...}

    if __name__ == "__main__":
        main()
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Type

__all__ = ("Benchmark", "BenchmarkResult", "main", "registry")

registry: List[Type["Benchmark"]] = []


class BenchmarkResult(dict):

    @property
    def failed(self) -> bool:
        return bool(self.get("error"))


class Benchmark:
    """Subclass, set ``name`` (a format template) and ``params`` (a dict of
    lists), implement ``run(**params) -> dict``.  Subclasses auto-register.
    """

    name: str = ""
    params: Dict[str, List[Any]] = {}
    timeout_s: float = 1800.0

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.name:
            registry.append(cls)

    @classmethod
    def cases(cls) -> Iterator[Tuple[str, Dict[str, Any]]]:
        keys = list(cls.params)
        for combo in itertools.product(*(cls.params[k] for k in keys)):
            kwargs = dict(zip(keys, combo))
            yield cls.name.format(**kwargs), kwargs

    def run(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


def _all_cases() -> Iterator[Tuple[Type[Benchmark], str, Dict[str, Any]]]:
    for cls in registry:
        for case_name, kwargs in cls.cases():
            yield cls, case_name, kwargs


def _run_child(script: str, case_name: str,
               timeout_s: float) -> BenchmarkResult:
    """Run one case isolated in a fresh interpreter.

    Children run one after another, and this parent process never imports
    JAX, so it never opens a backend: one process at a time holds the card
    (a JAX process reserves most of its memory when it first uses it)."""
    cmd = [sys.executable, script, "--run-case", case_name]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return BenchmarkResult(name=case_name, error="timeout",
                               elapsed_s=time.time() - t0)
    if proc.returncode != 0:
        return BenchmarkResult(name=case_name, error="crashed",
                               stderr=proc.stderr[-2000:],
                               elapsed_s=time.time() - t0)
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            payload = json.loads(line)
        except json.JSONDecodeError:
            continue
        return BenchmarkResult(name=case_name, elapsed_s=time.time() - t0,
                               **payload)
    return BenchmarkResult(name=case_name, error="no-result",
                           stderr=proc.stderr[-2000:],
                           elapsed_s=time.time() - t0)


def _execute_case(case_name: str) -> None:
    """Child-process entry: find the case, run it, print one JSON line."""
    from fewbit_tpu.util import setup_compile_cache

    setup_compile_cache()
    for cls, name, kwargs in _all_cases():
        if name == case_name:
            result = cls().run(**kwargs)
            print(json.dumps(result), flush=True)
            return
    print(json.dumps({"error": f"unknown case {case_name!r}"}), flush=True)
    sys.exit(1)


def _format_table(results: List[BenchmarkResult]) -> str:
    if not results:
        return "(no cases matched)"
    keys: List[str] = []
    for r in results:
        for k in r:
            if k not in ("name",) and k not in keys:
                keys.append(k)
    rows = [["name"] + keys]
    for r in results:
        rows.append([str(r.get("name", ""))] +
                    [_fmt(r.get(k)) for k in keys])
    widths = [max(len(row[i]) for row in rows) for i in range(len(rows[0]))]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths))
        for row in rows)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if v is None:
        return ""
    return str(v)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="fewbit-tpu benchmarks")
    parser.add_argument("-f", "--filter", default=".*",
                        help="regex over case names")
    parser.add_argument("--list", action="store_true",
                        help="list matching cases and exit")
    parser.add_argument("--csv", action="store_true", help="CSV output")
    parser.add_argument("--no-isolation", action="store_true",
                        help="run cases in-process (debugging)")
    parser.add_argument("--run-case", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.run_case:
        _execute_case(args.run_case)
        return 0

    pattern = re.compile(args.filter)
    script = sys.argv[0]
    selected = [(cls, name, kwargs) for cls, name, kwargs in _all_cases()
                if pattern.search(name)]
    if args.list:
        for _, name, _ in selected:
            print(name)
        return 0

    results = []
    for cls, name, kwargs in selected:
        print(f"running {name} ...", file=sys.stderr, flush=True)
        if args.no_isolation:
            try:
                payload = cls().run(**kwargs)
                results.append(BenchmarkResult(name=name, **payload))
            except Exception as exc:  # noqa: BLE001
                results.append(BenchmarkResult(name=name, error=repr(exc)))
        else:
            results.append(_run_child(script, name, cls.timeout_s))

    if args.csv:
        keys = sorted({k for r in results for k in r})
        print(",".join(keys))
        for r in results:
            print(",".join(_fmt(r.get(k)) for k in keys))
    else:
        print(_format_table(results))
    return 0
