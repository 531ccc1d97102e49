"""The oracle CLI (counterpart of cudasp_tpu/oracle/__main__.py): the
reference's developer scripts as subcommands, on the port's own oracle
copies. For the same arguments it writes the same standard output and
exits with the same code as the JAX package's.

    python -m cudasp_tpu_torch.oracle compute-expected --tweak <128hex> \
        --scan-key <64hex> --spend-key <128hex> [--label <128hex>]...
        -> candidate upper-64 values [base, label_0, ...]

    python -m cudasp_tpu_torch.oracle which-case ... --value N
        -> which candidate (base / label_i) produced a match value

    python -m cudasp_tpu_torch.oracle decompress-tweak --sec1 <66hex>
        -> 64-byte LE blob hex (p === 3 mod 4 square root)

    python -m cudasp_tpu_torch.oracle upper64 --x <64hex>
        -> signed int64 of bits 192..255

    python -m cudasp_tpu_torch.oracle tagged-hash --msg <hex>
        -> BIP0352/SharedSecret tagged hash

    python -m cudasp_tpu_torch.oracle gen-vectors --rows N [--seed S]
        [--match-every K] [--outputs M]
        -> a keys line, then a JSONL test table (random.Random(seed): the
        same seed gives the same lines in both packages)

    python -m cudasp_tpu_torch.oracle decode-blob --blob <hex>
        -> byte-order forensics of a 32-B scalar / 64-B point wire blob:
        LE and BE hex, integer value, on-curve check, upper64 of x

    python -m cudasp_tpu_torch.oracle convert-vector --scan-key-be <64hex>
        [--spend-pub <128hex>] [--tweak <128|130hex>] [--output N]...
        -> BIP-352 big-endian vector material as LE wire blobs + a SQL
        INSERT for the cudasp_scan test table

All key and blob arguments are in the scan API's wire format
(little-endian blobs). Imports neither torch nor jax itself (the
package's __init__ imports torch).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import ec as EC
from . import encoding as ENC
from . import pipeline as PIPE


def _hex(s: str) -> bytes:
    return bytes.fromhex(s.removeprefix("0x"))


def _keys(args):
    scan_key = ENC.blob32_to_scalar(_hex(args.scan_key))
    spend = ENC.blob64_to_point(_hex(args.spend_key))
    labels = [ENC.blob64_to_point(_hex(lb)) for lb in (args.label or [])]
    return scan_key, spend, labels


def cmd_compute_expected(args):
    tweak = ENC.blob64_to_point(_hex(args.tweak))
    scan_key, spend, labels = _keys(args)
    vals = PIPE.candidate_values(tweak, scan_key, spend, labels)
    names = ["base"] + [f"label_{i}" for i in range(len(labels))]
    for n, v in zip(names, vals):
        print(f"{n}: {v}")
    return 0


def cmd_which_case(args):
    tweak = ENC.blob64_to_point(_hex(args.tweak))
    scan_key, spend, labels = _keys(args)
    vals = PIPE.candidate_values(tweak, scan_key, spend, labels)
    names = ["base"] + [f"label_{i}" for i in range(len(labels))]
    for n, v in zip(names, vals):
        if v == args.value:
            print(n)
            return 0
    print("no-match", file=sys.stderr)
    return 1


def cmd_decompress_tweak(args):
    raw = _hex(args.sec1)
    if len(raw) != 33 or raw[0] not in (2, 3):
        raise SystemExit("need 33-byte compressed SEC1 (02/03 prefix)")
    pt = EC.decompress_point(raw)
    print(ENC.point_to_blob64(pt).hex())
    return 0


def cmd_upper64(args):
    x = int(args.x.removeprefix("0x"), 16)
    print(PIPE.upper64_signed(x))
    return 0


def cmd_tagged_hash(args):
    print(PIPE.tagged_hash(PIPE.TAG, _hex(args.msg)).hex())
    return 0


def cmd_gen_vectors(args):
    import random

    rng = random.Random(args.seed)
    g = (EC.GX, EC.GY)
    scan_key = rng.randrange(1, EC.N)
    spend = EC.ec_mul(g, rng.randrange(1, EC.N))
    keys = {
        "scan_private_key": ENC.scalar_to_blob32(scan_key).hex(),
        "spend_public_key": ENC.point_to_blob64(spend).hex(),
    }
    print(json.dumps({"keys": keys}))
    for i in range(args.rows):
        tweak = EC.ec_mul(g, rng.randrange(1, EC.N))
        is_match = (i % args.match_every) == 0
        outs = [rng.randrange(-2**62, 2**62) for _ in range(args.outputs)]
        if is_match:
            outs[0] = PIPE.candidate_values(tweak, scan_key, spend)[0]
        print(json.dumps({
            "txid": i.to_bytes(32, "big").hex(),
            "height": 100 + i,
            "tweak_key": ENC.point_to_blob64(tweak).hex(),
            "outputs": outs,
            "expect_match": is_match,
        }))
    return 0


def cmd_decode_blob(args):
    """Byte-order forensics of a wire blob."""
    raw = _hex(args.blob)
    if len(raw) == 32:
        v = int.from_bytes(raw, "little")
        print("kind: scalar (32 B, little-endian)")
        print(f"le_hex: {raw.hex()}")
        print(f"be_hex: {raw[::-1].hex()}")
        print(f"int: {v}")
        print(f"in_order_range: {0 < v < EC.N}")
        return 0
    if len(raw) == 64:
        x = int.from_bytes(raw[:32], "little")
        y = int.from_bytes(raw[32:], "little")
        print("kind: point (64 B, LE x || LE y)")
        print(f"x_be: {x:064x}")
        print(f"y_be: {y:064x}")
        on = (y * y - (x * x * x + 7)) % EC.P == 0
        print(f"on_curve: {on}")
        print(f"y_parity: {'odd' if y & 1 else 'even'}")
        print(f"upper64_of_x: {PIPE.upper64_signed(x)}")
        return 0
    raise SystemExit(f"blob must be 32 or 64 bytes, got {len(raw)}")


def cmd_convert_vector(args):
    """BIP-352 test-vector material (big-endian hex, the BIP's wire forms)
    -> the scan API's little-endian blobs + a ready SQL INSERT."""
    out = {}
    if args.scan_key_be:
        out["scan_private_key"] = _hex(args.scan_key_be)[::-1].hex()
    if args.spend_pub:
        raw = _hex(args.spend_pub)
        if len(raw) == 65 and raw[0] == 4:     # uncompressed SEC1, BE
            raw = raw[1:33][::-1] + raw[33:][::-1]
        elif len(raw) == 33 and raw[0] in (2, 3):
            p = EC.decompress_point(raw)
            raw = ENC.point_to_blob64(p)
        elif len(raw) != 64:
            raise SystemExit("spend-pub must be 33/64/65 bytes")
        out["spend_public_key"] = raw.hex()
    tweak_hex = None
    if args.tweak:
        raw = _hex(args.tweak)
        if len(raw) == 65 and raw[0] == 4:
            raw = raw[1:]                      # already LE x||y in vectors
        if len(raw) != 64:
            raise SystemExit("tweak must be 64 or 65 bytes")
        tweak_hex = raw.hex()
        out["tweak_key"] = tweak_hex
    for k, v in out.items():
        print(f"{k}: {v}")
    if tweak_hex:
        outs = ", ".join(str(v) for v in (args.output or [0]))
        txid = "\\x00" * 32
        print("sql: INSERT INTO test_data VALUES (BLOB '" + txid +
              f"', {args.height}, BLOB '" +
              "".join(f"\\x{tweak_hex[i:i+2]}"
                      for i in range(0, 128, 2)) +
              f"', [{outs}]);")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cudasp_tpu_torch.oracle")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def keyargs(p):
        p.add_argument("--tweak", required=True, help="64-B LE point hex")
        p.add_argument("--scan-key", required=True, help="32-B LE scalar hex")
        p.add_argument("--spend-key", required=True, help="64-B LE point hex")
        p.add_argument("--label", action="append", help="64-B LE point hex")

    p = sub.add_parser("compute-expected")
    keyargs(p)
    p.set_defaults(fn=cmd_compute_expected)

    p = sub.add_parser("which-case")
    keyargs(p)
    p.add_argument("--value", type=int, required=True)
    p.set_defaults(fn=cmd_which_case)

    p = sub.add_parser("decompress-tweak")
    p.add_argument("--sec1", required=True, help="33-B compressed point hex")
    p.set_defaults(fn=cmd_decompress_tweak)

    p = sub.add_parser("upper64")
    p.add_argument("--x", required=True, help="affine x as big-endian hex")
    p.set_defaults(fn=cmd_upper64)

    p = sub.add_parser("tagged-hash")
    p.add_argument("--msg", required=True, help="message hex (37 B in the pipeline)")
    p.set_defaults(fn=cmd_tagged_hash)

    p = sub.add_parser("gen-vectors")
    p.add_argument("--rows", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--match-every", type=int, default=4)
    p.add_argument("--outputs", type=int, default=3)
    p.set_defaults(fn=cmd_gen_vectors)

    p = sub.add_parser("decode-blob")
    p.add_argument("--blob", required=True,
                   help="32-B scalar or 64-B point wire blob hex")
    p.set_defaults(fn=cmd_decode_blob)

    p = sub.add_parser("convert-vector")
    p.add_argument("--scan-key-be", help="32-B big-endian scalar hex")
    p.add_argument("--spend-pub", help="33/64/65-B public key hex")
    p.add_argument("--tweak", help="64/65-B tweak point hex")
    p.add_argument("--height", type=int, default=100)
    p.add_argument("--output", action="append", type=int,
                   help="outputs list entry (repeatable)")
    p.set_defaults(fn=cmd_convert_vector)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
