"""Golden test vectors of the reference's SQL test suite (rows at heights
100/200/300/400 and the wrong-key negative case): facts about the BIP-352
pipeline that every implementation must reproduce bit for bit."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class GoldenRow:
    height: int
    txid: bytes
    tweak_blob: bytes          # 64-byte LE x||y
    outputs: Tuple[int, ...]   # signed int64 candidate values


@dataclass(frozen=True)
class GoldenCase:
    name: str
    scan_key_blob: bytes       # 32-byte LE scalar
    spend_blob: bytes          # 64-byte LE x||y
    label_blobs: Tuple[bytes, ...]
    rows: Tuple[GoldenRow, ...]
    expected_heights: Tuple[int, ...]  # heights of rows that must match


def _h(s: str) -> bytes:
    return bytes.fromhex(s)


# --- Row data (cudasp.test:19-38, 76-100) -----------------------------------

ROW_100 = GoldenRow(
    height=100,
    txid=_h("00010203"),
    tweak_blob=_h(
        "f9e75ef69a86881254529267c5074247"
        "28fc9cb6867849dc961a9ecd23f58eef"
        "c8ac4b3e4b39d2ad3ddaecfa8c118a25"
        "1e8c265a4ec43d96b0c0252fa3579af5"
    ),
    outputs=(1714273258699162470, 67890),
)

ROW_200 = GoldenRow(
    height=200,
    txid=_h("00010204"),
    tweak_blob=_h(
        "040096db612390ee6cef521e784c897c"
        "446a26cea8e28819962e5316c253c24a"
        "501e53f71071162afab559954064f0cc"
        "b7a6779c23b305597b6335829cc1f5b7"
    ),
    outputs=(4512552348537027144, 99999),
)

ROW_300 = GoldenRow(
    height=300,
    txid=_h("00010205"),
    tweak_blob=_h(
        "e82e64d566c55e9747f2f61559f983bb"
        "67bacffe07d6831018c0d66344c1be14"
        "c38032a48f5b3c56b5b6286a06c02708"
        "46b7b852cd318d9a137173a5b41c2f84"
    ),
    outputs=(-4740445252767345406,),
)

ROW_400 = GoldenRow(
    height=400,
    txid=_h("00010206"),
    tweak_blob=ROW_300.tweak_blob,
    outputs=(-1265772155233867786,),
)

# --- Keys -------------------------------------------------------------------

# gECC test-case-0 scan key (cudasp.test:42): scalar
# 0x0278927476e92caa3912937a7f003e45c741ddc47d80d70ae8f35c0c7f3c78fd (LE blob)
SCAN_KEY_GECC = _h(
    "fd783c7f0c5cf3e80ad7807dc4dd41c7453e007f7a931239aa2ce97674927802"
)
SPEND_GECC = _h(
    "9817f8165b81f259d928ce2ddbfc9b02070b87ce9562a055acbbdcf97e66be79"
    "b8d410fb8fd0479c195485a648b417fda808110efcfba45d65c4a32677da3a48"
)

# BIP-352 official vector keys (cudasp.test:54)
SCAN_KEY_BIP352 = _h(
    "2c1f0cb94db3946522cc1487256535dd33a1f911946baff817a72880064e690f"
)
SPEND_BIP352 = _h(
    "36cf8fcd4d4890ab6c1083aeb5b50c260c20acda7839120e3575836f6d85c95c"
    "e0d705e31ff9fdcce67a8f3598871c6dfbe6bcde8a51cb7b48b0f95be0ea94de"
)

# Wrong-key negative case (cudasp.test:66)
SCAN_KEY_WRONG = _h(
    "0000000000000000000000000000000000000000000000000000000000000001"
)
SPEND_WRONG = _h(
    "79be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798"
    "b8d410fb8fd0479c195485a648b417fda808110efcfba45d65c4a32677da3a48"
)

# Label case 1 (height 300, cudasp.test:82): label == spend_public_key
SCAN_KEY_LABEL1 = _h(
    "fd68d729f226825187f48f1ddcc94fec7880476623edfdd54826ca062ea8b711"
)
SPEND_LABEL1 = _h(
    "f5a6027e8b28b4cfd03dd0220639ce7642848b87218b2757ff84d4da9f3bd4ec"
    "a51cdff28a7d875af81ea50ea21d55cb002ea4ed5a902e37c04a619fc8efea3f"
)
LABEL1 = SPEND_LABEL1

# Label case 2 (height 400, cudasp.test:104): distinct label key
SCAN_KEY_LABEL2 = SCAN_KEY_BIP352
SPEND_LABEL2 = SPEND_BIP352
LABEL2 = _h(
    "cd63f9212a2deebde8a71e9ea23f6f958c47c41d2ed74b9617fe6fb554d1524e"
    "292fabddbdcbb643eafc328875c46d75a1d697b2b31c42d38aa93f85eab34bc1"
)

# --- Cases (query, expected matches) ----------------------------------------

CASES: List[GoldenCase] = [
    GoldenCase(
        name="gecc_case0",
        scan_key_blob=SCAN_KEY_GECC,
        spend_blob=SPEND_GECC,
        label_blobs=(),
        rows=(ROW_100, ROW_200),
        expected_heights=(100,),
    ),
    GoldenCase(
        name="bip352_vector",
        scan_key_blob=SCAN_KEY_BIP352,
        spend_blob=SPEND_BIP352,
        label_blobs=(),
        rows=(ROW_100, ROW_200),
        expected_heights=(200,),
    ),
    GoldenCase(
        name="wrong_keys_no_match",
        scan_key_blob=SCAN_KEY_WRONG,
        spend_blob=SPEND_WRONG,
        label_blobs=(),
        rows=(ROW_100,),
        expected_heights=(),
    ),
    GoldenCase(
        name="label_equals_spend",
        scan_key_blob=SCAN_KEY_LABEL1,
        spend_blob=SPEND_LABEL1,
        label_blobs=(LABEL1,),
        rows=(ROW_300,),
        expected_heights=(300,),
    ),
    GoldenCase(
        name="label_distinct",
        scan_key_blob=SCAN_KEY_LABEL2,
        spend_blob=SPEND_LABEL2,
        label_blobs=(LABEL2,),
        rows=(ROW_400,),
        expected_heights=(400,),
    ),
    GoldenCase(
        name="label_missing_no_match",
        scan_key_blob=SCAN_KEY_LABEL2,
        spend_blob=SPEND_LABEL2,
        label_blobs=(),
        rows=(ROW_400,),
        expected_heights=(),
    ),
]
