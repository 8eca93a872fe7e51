"""The port's measurement tools, on the CPU: how ``tools/profile_step.py``
groups the kernels it times, and how ``tools/sass_census.py`` reads the
compiler's register report. Neither needs a card for this: the kernel names
come from the sources, the report is written out here.
"""
import re

import pytest

from vil_tpu_torch.ops.kernels import build
from vil_tpu_torch.tools import profile_step, sass_census

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _kernel_names() -> list[str]:
    """Every __global__ kernel of csrc/*.cu."""
    return sorted({n for src in build._sources() for n in _GLOBAL.findall(src.read_text())})


def _profiled(name: str) -> str:
    """The name as torch.profiler reports a launch of it (demangled)."""
    return f"void vil::{name}<32>(vil::SampledNbh, __nv_bfloat16 const*, int)"


def test_the_sources_hold_the_kernels():
    names = _kernel_names()
    assert "vil_mode_attention_fwd_wgmma" in names and "vil_block_bwd_wgrad_wgmma" in names
    assert len(names) >= 40


@pytest.mark.parametrize("name", [n for n in _kernel_names() if not n.startswith("layout_probe")])
def test_every_model_kernel_has_a_family_of_its_own(name):
    """Each kernel of the model's paths is counted under its kernel's family
    (B1-B9), never under a library family such as GEMM or reduction."""
    assert profile_step.family(_profiled(name)).startswith("B"), name


@pytest.mark.parametrize("name,fam", [
    ("vil_mode_attention_fwd_wgmma", "B5 sampled-neighbour fwd"),
    ("vil_mode_attention_fwd_kernel", "B5 sampled-neighbour fwd"),
    ("vil_mode_attention_bwd_wgmma_pass1", "B6 sampled-neighbour bwd"),
    ("vil_block_bwd_attn_wgmma_pass1", "B9b fused block bwd: attention"),
    ("vil_block_bwd_attn_wgmma_pass2", "B9b fused block bwd: attention"),
    ("vil_block_bwd_attn_pass1", "B9b fused block bwd: attention"),
    ("vil_block_bwd_proj_out_wgmma", "B9b fused block bwd: products"),
    ("vil_block_bwd_wgrad_wgmma", "B9b fused block bwd: products"),
    ("vil_block_bwd_proj_in_wgmma", "B9b fused block bwd: products"),
    ("vil_block_bwd_wgrad", "B9b fused block bwd: products"),
    ("vil_block_bwd_glo", "B9b fused block bwd: rest"),
    ("vil_block_bwd_bgrad", "B9b fused block bwd: rest"),
    ("vil_block_bwd_reduce", "B9b fused block bwd: rest"),
    # (ids from before B9a and B8b were split by part)
    pytest.param("vil_block_fwd_proj_qkv", "B9a fused block fwd: projections",
                 id="vil_block_fwd_proj_qkv-B9a fused block fwd"),
    pytest.param("vil_ln_bwd_reduce", "B8 LayerNorm bwd: reduce",
                 id="vil_ln_bwd_reduce-B8 LayerNorm bwd"),
    ("vil_block_fwd_proj_qkv_wgmma", "B9a fused block fwd: projections"),
    ("vil_block_fwd_attn_wgmma", "B9a fused block fwd: attention"),
    ("vil_block_fwd_attention", "B9a fused block fwd: attention"),
    ("vil_block_fwd_proj_out_wgmma", "B9a fused block fwd: output projection"),
    ("vil_block_fwd_proj_out", "B9a fused block fwd: output projection"),
    ("vil_ln_bwd_rows", "B8 LayerNorm bwd: rows"),
    ("vil_ln_fwd", "B8 LayerNorm fwd"),
])
def test_b5_and_b9b_kernels_map_to_their_families(name, fam):
    """B5's two kernels (bf16 on the tensor cores, f32 on the CUDA cores),
    B9b's, split into its attention passes, its products and the rest, B9a's
    into its projections, its attention and its output projection, and
    B8b's into its rows and its reduction."""
    assert profile_step.family(_profiled(name)) == fam


def test_census_reads_registers_from_the_compiler_report():
    report = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3vil28vil_mode_attention_fwd_wgmmaILi32EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN3vil28vil_mode_attention_fwd_wgmmaILi32EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3vil20vil_block_bwd_reduceEPKfPfil' for 'sm_90a'
ptxas info    : Function properties for _ZN3vil20vil_block_bwd_reduceEPKfPfil
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 384 bytes cmem[0]
"""
    assert sass_census.registers(report) == {
        "_ZN3vil28vil_mode_attention_fwd_wgmmaILi32EEEvv": 96,
        "_ZN3vil20vil_block_bwd_reduceEPKfPfil": 12,
    }


def test_census_names_keep_every_template_argument():
    """Two instances that differ in a bool template argument keep apart
    names (B2's biased and unbiased pass 1)."""
    line = "void vil::vil_attention_bwd_wgmma_pass1<(int)32, (bool)1>(const __nv_bfloat16 *, int)"
    assert sass_census.kernel_name(line) == "vil::vil_attention_bwd_wgmma_pass1<32, 1>"
    assert sass_census.kernel_name(line.replace("(bool)1", "(bool)0")).endswith("<32, 0>")
    assert sass_census.kernel_name("void vil::vil_ln_fwd<float>(const float *)") == (
        "vil::vil_ln_fwd<float>")


def test_census_counts_opcodes_of_each_function():
    """``count_classes`` counts an instruction of a class by its opcode,
    predicated or not, with or without modifiers, and not an opcode that
    only begins with a class's name (LDSM) nor a class's name among the
    operands; each function's counts apart."""
    sass = """
        Function : _Z1av
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @!P0 FFMA R2, R3, R4, R5 ;
        /*0020*/                   LDS.U.128 R4, [R2] ;
        /*0030*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0040*/               @UP1 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        Function : _Z1bv
        /*0000*/                   LDGSTS.E.BYPASS.128 [R1], desc[UR4][R2.64] ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   IADD3 R2, R2, FFMA, RZ ;
    """
    counts = sass_census.count_classes(sass)
    assert counts["_Z1av"] == dict(HGMMA=1, HMMA=0, LDGSTS=0, UTMALDG=0, FFMA=1, LDS=1)
    assert counts["_Z1bv"] == dict(HGMMA=0, HMMA=0, LDGSTS=1, UTMALDG=0, FFMA=1, LDS=0)
