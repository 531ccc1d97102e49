"""What chip_smoke.py reports of the built libraries, on the CPU: the
readers of nvcc's ptxas -v logs and of cuobjdump -sass listings in
cudasp_tpu_torch/ops/kernels.py (registers, stack, spills and the
instruction counts of each scan instantiation, the field cases of the
bench kernel and the device functions that stay calls), and that a
missing cuobjdump raises. The tools themselves run only beside nvcc."""

import types

import pytest

from cudasp_tpu_torch.ops import kernels as TK

FIXED = ("_ZN2sp11scan_kernelINS_11FixedLadderEEEvPKjS3_S3_S3_T_S3_S3_iS3_"
         "PKiiiiiiiPv")
STATIC = "_ZN2sp11scan_kernelI9KeyLadderEEvPKjS3_S3_S3_T_S3_S3_iS3_PKiiiiiiiPv"

PTXAS_LOG = f"""ptxas info    : 0 bytes gmem, 256 bytes cmem[3]
ptxas info    : Function properties for _ZN2sp6fe_invENS_2feE
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{FIXED}' for 'sm_90a'
ptxas info    : Function properties for {FIXED}
    1792 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 1792 bytes cumulative \
stack size, 384 bytes cmem[0]
ptxas info    : Compiling entry function '{STATIC}' for 'sm_90a'
ptxas info    : Function properties for {STATIC}
    1808 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""

SASS = f"""\tcode for sm_90a
\t\tFunction : {FIXED}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R6, RZ ;
        /*0020*/               @P0 IMAD.HI.U32.X R2, P1, R4, R6, R8, P0 ;
        /*0030*/              @!P0 IADD3.X R2, P1, R4, R6, R8, P0, !PT ;
        /*0040*/                   LDL.128 R4, [R1+0x10] ;
        /*0050*/                   STL.64 [R1], R4 ;
        /*0060*/                   CALL.REL.NOINC 0x100 ;
        /*0070*/                   IMAD.MOV.U32 R3, RZ, RZ, R5 ;
        /*0080*/                   IMAD.X R3, RZ, RZ, R5, P0 ;
\t\tFunction : _ZN2sp5probe12alu_kernelINS0_6AluMulEEEvPKiPiii
        /*0000*/                   IMAD R1, R2, R3, RZ ;
\t\tFunction : _ZN2sp5probe12bench_kernelINS0_8FieldSqrEEEvPKjS3_Pjii
        /*0000*/                   IMAD.WIDE.U32 R2, R4, R4, RZ ;
        /*0010*/                   IADD3 R2, P0, R2, R3, RZ ;
"""


def test_ptxas_info_reads_registers_stack_and_spills():
    info = TK.ptxas_info(PTXAS_LOG)
    assert info == {
        "fe_inv": {"stack": 24, "spill_stores": 0, "spill_loads": 0},
        "fixed": {"stack": 1792, "spill_stores": 8, "spill_loads": 12,
                  "registers": 168},
        "static": {"stack": 1808, "spill_stores": 0, "spill_loads": 0,
                   "registers": 255}}


def test_ptxas_info_skips_unnamed_functions():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN2sp5probe12alu_kernelINS0_6AluMulEEEvPKiPiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 12 registers\n")
    assert TK.ptxas_info(log) == {}
    assert TK.ptxas_info("") == {}


def test_sass_counts_by_function(monkeypatch):
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout=SASS)

    monkeypatch.setattr(TK, "cuobjdump", lambda nvcc: "/x/cuobjdump")
    monkeypatch.setattr(TK.subprocess, "run", run)
    counts = TK.sass_counts("lib.so", "/x/nvcc")
    assert seen["cmd"] == ["/x/cuobjdump", "-sass", "lib.so"]
    assert set(counts) == {"fixed", "bench field sqr"}
    assert counts["fixed"] == {"IMAD": 4, "IMAD.WIDE": 1, "IMAD.HI": 1,
                               "IMAD.X": 2, "IMAD.MOV": 1, "IADD3": 1,
                               "LDL": 1, "STL": 1, "CALL": 1, "all": 9}
    assert counts["bench field sqr"]["IMAD"] == 1
    assert counts["bench field sqr"]["all"] == 2
    assert all(set(c) == set(TK.SASS_KINDS) for c in counts.values())


def test_cuobjdump_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TK.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        TK.cuobjdump(str(tmp_path / "nvcc"))


def test_cuobjdump_beside_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(TK.shutil, "which", lambda name: None)
    (tmp_path / "cuobjdump").write_text("")
    assert TK.cuobjdump(str(tmp_path / "nvcc")) \
        == str(tmp_path / "cuobjdump")


@pytest.mark.parametrize("mangled, name", [
    (FIXED, "fixed"),
    (FIXED.replace("Fixed", "Wnaf"), "wnaf"),
    (STATIC, "static"),
    ("_ZN2sp5probe12bench_kernelINS0_8FieldMulEEEvPKjS3_Pjii",
     "bench field mul"),
    ("_ZN2sp5probe12bench_kernelINS0_8FieldSqrEEEvPKjS3_Pjii",
     "bench field sqr"),
    ("_ZN2sp6fe_invENS_2feE", "fe_inv"),
    ("_ZN2sp7fe_sqrtENS_2feE", "fe_sqrt"),
    ("_ZN2sp11pt_dbl_callENS_3jacE", "pt_dbl_call"),
    ("_ZN2sp12pt_madd_callENS_3jacENS_2feES1_", "pt_madd_call"),
    ("_ZN2sp5probe12alu_kernelINS0_6AluMulEEEvPKiPiii", None),
    ("_ZN2sp5probe12bench_kernelINS0_8FieldAddEEEvPKjS3_Pjii", None),
])
def test_label_names_every_instantiation(mangled, name):
    assert TK.label(mangled) == name
