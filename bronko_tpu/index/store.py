""".bkdb persistence for the bucket index.

The reference serializes its hashmap with bincode (build.rs:122-143); our
.bkdb is an NPZ container of the dense CSR arrays plus JSON metadata — it
deserializes straight into device-puttable buffers with no decode step.
Loaded with the same k-consistency check as call.rs:193-197.
"""

from __future__ import annotations

import io
import json
import zlib

import numpy as np

from bronko_tpu.index.model import BronkoIndex, FileMeta, SeqMeta

MAGIC = "bronko-tpu-bkdb-v2"   # v2: 10-bit seq ids in post_meta
MAGIC_V1 = "bronko-tpu-bkdb-v1"  # 8-bit seq ids; converted on load


def save_index(path: str, index: BronkoIndex) -> None:
    meta = {
        "magic": MAGIC,
        "k": index.k,
        "files": [
            {"name": f.name, "seq_names": [s.name for s in f.sequences],
             "seq_lens": [s.length for s in f.sequences]}
            for f in index.files
        ],
    }
    seq_blob = zlib.compress(b"".join(s.seq for f in index.files for s in f.sequences), 6)
    out = path if path.endswith(".bkdb") else path + ".bkdb"
    with open(out, "wb") as fh:
        np.savez(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            keys=index.keys,
            offsets=index.offsets,
            post_loc=index.post_loc,
            post_meta=index.post_meta,
            seq_blob=np.frombuffer(seq_blob, dtype=np.uint8),
        )


def load_index(path: str, expect_k: int | None = None) -> BronkoIndex:
    from bronko_tpu.index.bincode_compat import load_reference_bkdb, sniff_format

    if sniff_format(path) == "bincode":
        # a database produced by the reference bronko binary
        index = load_reference_bkdb(path)
        if expect_k is not None and index.k != expect_k:
            raise ValueError(
                f"Database k is not the same as provided, please set -k to "
                f"{index.k} or build a new index"
            )
        return index
    with open(path, "rb") as fh:
        data = np.load(io.BytesIO(fh.read()), allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    if meta.get("magic") not in (MAGIC, MAGIC_V1):
        raise ValueError(f"{path} is not a bronko-tpu .bkdb file")
    k = int(meta["k"])
    if expect_k is not None and k != expect_k:
        raise ValueError(
            f"Database k is not the same as provided, please set -k to {k} "
            f"or build a new index"
        )
    seqs = zlib.decompress(bytes(data["seq_blob"]))
    files: list[FileMeta] = []
    pos = 0
    for f in meta["files"]:
        sequences = []
        for name, length in zip(f["seq_names"], f["seq_lens"]):
            sequences.append(SeqMeta(name, length, seqs[pos:pos + length]))
            pos += length
        files.append(FileMeta(f["name"], sequences))
    post_meta = data["post_meta"]
    if meta.get("magic") == MAGIC_V1:
        # v1 packed seq ids in 8 bits (idx 5 | seq 8 | file 16 | canon 1);
        # repack into the v2 layout (seq 10 bits)
        from bronko_tpu.index.model import pack_meta

        idx = post_meta & 0x1F
        seq_id = (post_meta >> 5) & 0xFF
        file_id = (post_meta >> 13) & 0xFFFF
        canon = (post_meta >> 29) & 1
        post_meta = pack_meta(idx, seq_id, file_id, canon)
    return BronkoIndex(
        k=k,
        keys=data["keys"],
        offsets=data["offsets"],
        post_loc=data["post_loc"],
        post_meta=post_meta,
        files=files,
    )
