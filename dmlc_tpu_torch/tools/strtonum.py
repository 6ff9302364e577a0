"""Number-scan fuzz harness, the port of ``dmlc_tpu/tools/strtonum.py``
(``test/strtonum_test.cc``): seeded decimal strings, one a libsvm line
``1 1:<value>``, against Python's correctly rounded ``float()``, within
``--ulp`` float32 ulps, through one of the two parse routes:

- ``--route native`` (the default, the JAX package's with its library
  loaded): the native core's chunk parse (``native.parse_libsvm_chunk``);
- ``--route python``: ``LibSVMParser.parse_chunk``, the token masks from
  the ``tokenize_boundaries`` kernel on ``--device`` (the card unless
  ``--device cpu``) and the numbers parsed by numpy on the host. This is
  the parse of every libsvm read that takes the Python stack
  (``create_parser(threaded=False)``, parsers built directly, mixed
  filesystems, a remote ``shuffle_chunks``, an armed determinism audit;
  ``data/parsers.py`` states the rules), so its users fuzz this route.

The report's parenthesis names the route (and the python route's device).

Usage::

    python -m dmlc_tpu_torch.tools strtonum [--n N] [--seed S] [--ulp U]
        [--route native|python] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def _gen_tokens(n: int, rng: np.random.RandomState) -> List[str]:
    """The reference's draw: fixed point, long fractions, scientific,
    zero-padded integers and long zero runs, 30 % negated."""
    toks: List[str] = []
    for _ in range(n):
        kind = rng.randint(0, 5)
        if kind == 0:
            toks.append(f"{rng.rand() * 10 ** rng.randint(-3, 6):.6f}")
        elif kind == 1:
            toks.append(f"{rng.rand():.{rng.randint(1, 18)}f}")
        elif kind == 2:
            toks.append(f"{(rng.rand() - 0.5) * 2:.8e}")
        elif kind == 3:
            s = str(rng.randint(0, 10 ** 9))
            toks.append("0" * rng.randint(0, 3) + s)
        else:
            toks.append("0." + "0" * rng.randint(0, 25)
                        + str(rng.randint(1, 10 ** 6)))
        if rng.rand() < 0.3 and not toks[-1].startswith("-"):
            toks[-1] = "-" + toks[-1]
    return toks


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="strtonum", description=__doc__)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ulp", type=int, default=1,
                    help="max float32 ulp difference tolerated")
    ap.add_argument("--route", choices=("native", "python"),
                    default="native", help="the parse route fuzzed")
    ap.add_argument("--device", default=None,
                    help="where the python route tokenizes (default: the "
                    "card)")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    toks = _gen_tokens(args.n, rng)
    chunk = "".join(f"1 1:{t}\n" for t in toks).encode()

    if args.route == "native":
        from dmlc_tpu_torch import native

        parsed = native.parse_libsvm_chunk(chunk)
        if parsed is None:
            print("ERROR: the native scan rejected the chunk",
                  file=sys.stderr)
            return 1
        got = np.asarray(parsed["values"], dtype=np.float32)
        route = "route=native"
    else:
        from dmlc_tpu_torch.data.parsers import LibSVMParser

        parser = LibSVMParser(source=None, nthread=1, device=args.device)
        block = parser.parse_chunk(chunk).to_block()
        got = np.asarray(block.value, dtype=np.float32)
        route = f"route=python, device={parser.device}"
    expect = np.asarray([float(t) for t in toks], dtype=np.float32)

    # ulp distance through the int32 view of the float bit patterns
    gi = got.view(np.int32).astype(np.int64)
    ei = expect.view(np.int32).astype(np.int64)
    ulps = np.abs(gi - ei)
    exact = int((ulps == 0).sum())
    bad = np.nonzero(ulps > args.ulp)[0]
    print(f"{args.n} values: {exact} exact, max ulp "
          f"{int(ulps.max()) if len(ulps) else 0} "
          f"({route})")
    if len(bad):
        for i in bad[:10]:
            print(f"ERROR: {toks[i]!r} -> {got[i]!r}, want {expect[i]!r} "
                  f"({ulps[i]} ulp)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
