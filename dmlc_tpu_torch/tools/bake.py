"""Offline shard bake: text corpus -> pre-tokenized ``.dtsh`` shards, the
port of ``dmlc_tpu/tools/bake.py``.

``python -m dmlc_tpu_torch.tools bake <src> <dst.dtsh> [--device cpu]``
parses the source once through ``create_parser`` on the device (the card
unless ``--device cpu``; a local or single-remote text source takes the
native route, any other is tokenized by the ``tokenize_boundaries`` kernel
there) and writes the RowBlocks as shards
(``io/shard.py``); every later epoch reads typed columns, no parse.

``--nparts N`` bakes N shard files at once on a thread pool, one a part
of the same byte split ``create_parser`` reads, so part k of the bake is
part k of a text read. A sidecar ``<dst>.bake.json`` keeps a digest of
the source bytes and the bake's parameters: a bake whose sidecar matches
and whose outputs exist is skipped (``--force`` bakes anyway). Outputs
are written to a temporary file and renamed, so an interrupted bake
leaves no readable torn shard under the final name.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from dmlc_tpu_torch.io.shard import SHARD_SUFFIX, ShardWriter, _local_path
from dmlc_tpu_torch.utils.device import resolve_device


def _source_digest(uri: str) -> str:
    """blake2b over the source files' names, sizes and bytes: the same
    corpus gives the same digest. The uri's ``?args`` are not part of the
    file names."""
    from dmlc_tpu_torch.io.input_split import list_split_files
    from dmlc_tpu_torch.io.uri_spec import URISpec

    h = hashlib.blake2b(digest_size=16)
    for path, size in sorted(list_split_files(URISpec(uri).uri)):
        h.update(path.encode())
        h.update(str(size).encode())
        with open(path, "rb") as fh:
            while True:
                buf = fh.read(1 << 20)
                if not buf:
                    break
                h.update(buf)
    return h.hexdigest()


def part_path(dst: str, k: int, nparts: int) -> str:
    """The file of part ``k`` of an ``nparts`` bake rooted at ``dst``."""
    if nparts == 1:
        return dst
    base = dst[:-len(SHARD_SUFFIX)] if dst.endswith(SHARD_SUFFIX) else dst
    return "%s-%05d-of-%05d%s" % (base, k, nparts, SHARD_SUFFIX)


def _bake_part(src: str, dst: str, data_format: str, k: int, nparts: int,
               rows_per_window: int, nthread: Optional[int],
               device) -> Dict:
    from dmlc_tpu_torch.data.parsers import create_parser

    tmp = "%s.tmp.%d" % (dst, os.getpid())
    parser = create_parser(src, k, nparts, data_format=data_format,
                           nthread=nthread, device=device)
    try:
        writer = ShardWriter(tmp, rows_per_window=rows_per_window)
        try:
            for block in parser:
                writer.write_block(block)
        finally:
            writer.close()
        os.replace(tmp, dst)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    finally:
        parser.close()
    return {"path": dst, "rows": writer.rows_written,
            "nnz": writer.nnz_written, "bytes": os.path.getsize(dst)}


def bake_dataset(src: str, dst: str, data_format: str = "auto",
                 nparts: int = 1, rows_per_window: int = 4096,
                 nthread: Optional[int] = None, force: bool = False,
                 device=None) -> Dict:
    """Bake ``src`` (any ``create_parser`` text format) into ``nparts``
    shard files rooted at ``dst``, parsing on ``device`` (None means
    cuda). Returns a summary; ``skipped`` is True when the sidecar
    matched."""
    device = resolve_device(device)
    dst = _local_path(dst)
    nparts = max(1, int(nparts))
    if data_format == "auto":
        # the resolved format goes into the sidecar, so that `bake x.svm`
        # and `bake x.svm --format libsvm` are one bake
        from dmlc_tpu_torch.io.uri_spec import URISpec

        data_format = URISpec(src).args.get("format") or "libsvm"
    if data_format == "shard":
        raise ValueError("source is already baked; bake reads text formats")
    sig = {
        "format": "dtsh-v1",
        "src": str(src),
        "src_digest": _source_digest(src),
        "data_format": str(data_format),
        "nparts": nparts,
        "rows_per_window": int(rows_per_window),
    }
    sidecar = dst + ".bake.json"
    outputs = [part_path(dst, k, nparts) for k in range(nparts)]
    if not force and os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = None
        if (prev and prev.get("sig") == sig
                and all(os.path.exists(p) for p in outputs)):
            return dict(prev, skipped=True)
    t0 = time.monotonic()

    def bake(k: int) -> Dict:
        return _bake_part(src, outputs[k], data_format, k, nparts,
                          rows_per_window, nthread, device)

    if nparts == 1:
        parts = [bake(0)]
    else:
        with concurrent.futures.ThreadPoolExecutor(max_workers=nparts) as pool:
            parts = list(pool.map(bake, range(nparts)))
    elapsed = time.monotonic() - t0
    summary = {
        "sig": sig,
        "outputs": parts,
        "rows": sum(p["rows"] for p in parts),
        "bytes": sum(p["bytes"] for p in parts),
        "seconds": round(elapsed, 3),
        "skipped": False,
    }
    tmp = "%s.tmp.%d" % (sidecar, os.getpid())
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    os.replace(tmp, sidecar)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dmlc_tpu_torch.tools bake",
        description="bake a text corpus into columnar .dtsh shards")
    ap.add_argument("src", help="source uri (libsvm/csv/...)")
    ap.add_argument("dst", help="output shard path (*.dtsh)")
    ap.add_argument("--format", default="auto", dest="data_format",
                    help="source format (default: auto via ?format= arg)")
    ap.add_argument("--nparts", type=int, default=1,
                    help="parallel bake partitions -> N shard files")
    ap.add_argument("--rows-per-window", type=int, default=4096,
                    help="rows per indexed window (shuffle/audit unit)")
    ap.add_argument("--nthread", type=int, default=None,
                    help="parse workers per partition")
    ap.add_argument("--force", action="store_true",
                    help="re-bake even when the content digest matches")
    ap.add_argument("--device", default=None,
                    help="where the text is tokenized (default: the card)")
    args = ap.parse_args(argv)
    summary = bake_dataset(
        args.src, args.dst, data_format=args.data_format,
        nparts=args.nparts, rows_per_window=args.rows_per_window,
        nthread=args.nthread, force=args.force, device=args.device)
    if summary.get("skipped"):
        print("bake: up to date (%d rows, digest %s)"
              % (summary["rows"], summary["sig"]["src_digest"][:12]))
        return 0
    mb = summary["bytes"] / 1e6
    secs = max(summary["seconds"], 1e-9)
    print("bake: %d rows -> %d shard file(s), %.1f MB in %.2fs (%.1f MB/s)"
          % (summary["rows"], len(summary["outputs"]), mb,
             summary["seconds"], mb / secs))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
