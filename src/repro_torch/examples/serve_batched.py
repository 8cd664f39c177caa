"""Batched serving driver, the reference's ``examples/serve_batched.py`` on
the port: serve the llama3.2-1b smoke config with requests sampled from the
paper's HumanEval length profile through the continuous-batching scheduler
(KV slot pool and slot-recycling admission; ``core/scheduler.py``). The
launcher ``repro_torch.launch.serve`` does the work; ``--policy fixed``
gives the run-to-completion baseline on the same trace.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List

from repro_torch.launch import serve

ARGS = ["--arch", "llama3.2-1b", "--smoke", "--n-requests", "8", "--batch-slots", "4",
        "--max-new", "16", "--profile", "llama_humaneval", "--arrival-rate", "20"]


def run(device: str = "cuda", policy: str = "continuous") -> Dict[str, Any]:
    """The launcher on the example's trace; returns its metrics."""
    return serve.main(ARGS + ["--policy", policy, "--device", str(device)])


def main(argv: List[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when there is no card) or cpu")
    ap.add_argument("--policy", choices=["continuous", "fixed"], default="continuous")
    args = ap.parse_args(argv)
    return run(args.device, args.policy)


if __name__ == "__main__":
    main()
