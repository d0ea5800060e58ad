"""Command-line utility to generate few-bit gradient quantisations.

``fewbit-tpu quantize <nobits> <module:func>`` differentiates the named
function with JAX autodiff (the reference bridges numpy through torch AD,
``cli.py:60-124``), runs the stepwise quantizer, and merges the result into
an npz archive loadable by :class:`fewbit_tpu.lut.StepwiseStore`.
"""

from __future__ import annotations

import argparse
import logging
import sys
from importlib import import_module
from pathlib import Path
from typing import Optional

import numpy as np

from fewbit_tpu import __version__
from fewbit_tpu.approx import approximate

__all__ = ("main",)

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARN,
    "error": logging.ERROR,
}


def quantize(nobits: int, spec: str, output: Optional[Path],
             max_iters: int, border_error: float, level_error: float,
             seed: Optional[int], domain: float, parity: bool) -> int:
    logging.info("loading function from spec %s", spec)
    module_name, func_name = spec.split(":", 1)
    func = getattr(import_module(module_name), func_name)

    import jax
    import jax.numpy as jnp

    grad_fn = jax.vmap(jax.grad(lambda t: func(t)))

    def fn_prim(xs: np.ndarray) -> np.ndarray:
        return np.asarray(func(jnp.asarray(xs, jnp.float64)))

    def fn(xs: np.ndarray) -> np.ndarray:
        return np.asarray(grad_fn(jnp.asarray(xs, jnp.float64)))

    dom = (0.0, domain) if parity else (-domain, domain)
    logging.info("running quantizer: %d bits on %s", nobits, dom)
    result, info = approximate(fn=fn, fn_prim=fn_prim,
                               cardinality=1 << nobits, domain=dom,
                               parity=parity, max_iters=max_iters,
                               beps=border_error, leps=level_error,
                               random_state=seed)
    if info["status"] != "converged":
        logging.error("failed to converge in %d iterations",
                      info["iterations"])
        return 1
    logging.info("converged in %d iterations; approximation:\n%s",
                 info["iterations"], result.pretty())

    if output:
        case = f"{func_name}{nobits:02d}"
        arrays = {f"{case}-borders": result.borders,
                  f"{case}-levels": result.levels}
        if output.exists():
            logging.info("merging into existing archive %s", output)
            try:
                with np.load(output) as npz:
                    merged = dict(npz)
                merged.update(arrays)
                arrays = merged
            except Exception:
                logging.error("could not read existing file; overwriting")
        np.savez(output, **arrays)
        logging.info("saved to %s", output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fewbit-tpu",
        description="Generate few-bit gradient quantisations for activation "
                    "functions.")
    parser.add_argument("--log-level", default="info",
                        choices=sorted(LOG_LEVELS))
    sub = parser.add_subparsers(dest="command")

    q = sub.add_parser("quantize", help="build and save a few-bit "
                                        "stepwise approximation")
    q.add_argument("nobits", type=int, help="number of bits")
    q.add_argument("spec", type=str,
                   help='qualified function name, e.g. "jax.nn:gelu"')
    q.add_argument("-o", "--output", type=Path, default=None,
                   help="npz archive to merge the result into")
    q.add_argument("-M", "--max-iters", type=int, default=10000)
    q.add_argument("-b", "--border-error", type=float, default=1e-6)
    q.add_argument("-l", "--level-error", type=float, default=1e-6)
    q.add_argument("-s", "--seed", type=int, default=None)
    q.add_argument("--domain", type=float, default=100.0,
                   help="half-width of the approximation domain")
    q.add_argument("--parity", action="store_true",
                   help="approximate on [0, domain] (symmetric derivative)")

    h = sub.add_parser("help", help="show help for a command")
    h.add_argument("topic", nargs="?", default=None,
                   help="command to describe (e.g. quantize)")

    sub.add_parser("version", help="show version")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(format="%(asctime)s %(levelname)s %(message)s",
                        level=LOG_LEVELS[args.log_level], stream=sys.stderr)
    if args.command == "version":
        print(f"fewbit-tpu {__version__}")
        return 0
    if args.command == "help":
        # Reference parity: ``fewbit help <command>`` prints the command's
        # usage (``/root/reference/fewbit/cli.py:169-177``).
        if args.topic is None:
            parser.print_help()
            return 0
        try:
            parser.parse_args([args.topic, "--help"])
        except SystemExit as exc:
            return int(exc.code or 0)
        return 0
    if args.command == "quantize":
        import jax

        # The quantizer differentiates tiny 1-D batches; run it on the host
        # in float64 (accelerators gain nothing here, and many lack f64).
        # Both flags are restored afterwards so an in-process caller (tests,
        # a program that quantizes then trains) keeps its own configuration.
        prev_platforms = jax.config.jax_platforms
        jax.config.update("jax_platforms", "cpu")
        try:
            with jax.enable_x64(True):
                return quantize(args.nobits, args.spec, args.output,
                                args.max_iters, args.border_error,
                                args.level_error, args.seed, args.domain,
                                args.parity)
        finally:
            jax.config.update("jax_platforms", prev_platforms)
    parser.print_usage()
    return 0


if __name__ == "__main__":
    sys.exit(main())
