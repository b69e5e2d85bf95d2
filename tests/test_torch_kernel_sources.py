"""The port's CUDA sources against what the Python side assumes of them.

The launchers keep some of a kernel's constants in Python (the plan, the
thresholds the CPU models of the tests use), and ``tools/kernel_ablation.py``
builds variants of a source by replacing its text. Neither can be checked by
a build here (no ``nvcc``), so these tests read the sources: each constant
the Python side mirrors has the kernel's value, and each text an ablation
replaces stands exactly once in its source.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from torchmetrics_tpu_torch.kernels import bert_match as kbm
from torchmetrics_tpu_torch.kernels import confmat as kcm
from torchmetrics_tpu_torch.kernels import hll as khll
from torchmetrics_tpu_torch.kernels import mask_iou as kmi
from torchmetrics_tpu_torch.kernels import pairwise as kpw
from torchmetrics_tpu_torch.kernels import perplexity as kppl
from torchmetrics_tpu_torch.kernels import poly_mmd as kpm
from torchmetrics_tpu_torch.kernels import quantile_hist as kqh
from torchmetrics_tpu_torch.kernels import retrieval as krt
from torchmetrics_tpu_torch.kernels import sdr_toeplitz as ksdr
from torchmetrics_tpu_torch.kernels import snr_moments as ksnr
from torchmetrics_tpu_torch.kernels import segmentation as kseg
from torchmetrics_tpu_torch.kernels import ssim as kss
from torchmetrics_tpu_torch.text import distinct

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "torchmetrics_tpu_torch" / "csrc"


def _source(name: str) -> str:
    return (CSRC / f"{name}.cu").read_text()


def _constant(source: str, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", source)
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


def _ablation():
    spec = importlib.util.spec_from_file_location("kernel_ablation", REPO / "tools" / "kernel_ablation.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(("python", "kernel"), [("COUNT_SHORT", "kCountShort"), ("COUNT_LONG", "kCountLong"),
                                                ("MAX_POSITIVES", "kMaxPositives"), ("MAX_THREADS", "kMaxThreads"),
                                                ("MAX_ITEMS", "kMaxItems"), ("DIGITS", "kDigits")])
def test_retrieval_constants_are_the_kernels(python, kernel):
    assert getattr(krt, python) == _constant(_source("retrieval"), kernel)


def test_ssim_tile_is_the_kernels():
    src = _source("ssim")
    assert kss.TILE_W == _constant(src, "kTileW")
    assert kss.TILE_H == _constant(src, "kWarps") * _constant(src, "kColRows")
    assert kss.THREADS == _constant(src, "kTileW") * _constant(src, "kWarps")


@pytest.mark.parametrize(("module", "python", "kernel"), [
    (kseg, "SHARED_CLASSES", "kSharedClasses"), (kseg, "THREADS", "kThreads"),
    (kpw, "COL_THREADS", "kColThreads"), (kpw, "CHUNK", "kChunk"), (kpw, "THREADS", "kThreads"),
], ids=lambda v: v if isinstance(v, str) else v.SOURCE)
def test_segmentation_and_pairwise_constants_are_the_kernels(module, python, kernel):
    assert getattr(module, python) == _constant(_source(module.SOURCE), kernel)


def test_segmentation_shared_histogram_fits_the_default_shared_memory():
    assert 3 * kseg.SHARED_CLASSES * 4 <= 48 * 1024
    assert kseg.CHUNK_ALIGN % 16 == 0 and kseg.MIN_CHUNK % kseg.CHUNK_ALIGN == 0
    assert "if (n_images < 1 || n_images > 65535" in _source("segmentation") and kseg.MAX_IMAGES == 65_535
    src = _source("pairwise")
    assert "constexpr int kRowThreads = kThreads / kColThreads;" in src and kpw.ROW_THREADS * kpw.COL_THREADS == kpw.THREADS
    # a thread's register tile of rows x cols sums, the block's (16 rows) x (16 cols): the entry's three instances
    for rows, cols in kpw.TILES:
        assert f"if (rows == {rows} && cols == {cols}) return launch<{rows}, {cols}>(" in src
        # two staged chunks of the block's x and y rows and a float p's table: two blocks an SM's 227 KB
        assert 2 * 4 * (2 * (kpw.ROW_THREADS * rows + kpw.COL_THREADS * cols) * (kpw.CHUNK + 4) + 256) <= 227 * 1024
    assert src.count("if (rows == ") == len(kpw.TILES)
    assert "(m + kTileN - 1) / kTileN > 65535" in src and kpw.MAX_COLS == 65_535 * kpw.COL_THREADS * 8


@pytest.mark.parametrize(("module", "python", "kernel"), [
    (ksnr, "THREADS", "kThreads"), (ksnr, "MAX_SPEAKERS", "kMaxSpeakers"), (ksdr, "MAX_LENGTH", "kMaxLength"),
    (ksnr, "LOADS", "kLoads"), (ksnr, "CLUSTER", "kCluster"), (ksdr, "MAX_THREADS", "kMaxThreads"),
    (ksdr, "MIN_ENTRIES", "kMinEntries"),
], ids=lambda v: v if isinstance(v, str) else v.SOURCE)
def test_audio_constants_are_the_kernels(module, python, kernel):
    assert getattr(module, python) == _constant(_source(module.SOURCE), kernel)


def test_snr_moments_source_matches_its_launcher():
    src = _source("snr_moments")
    eps = re.findall(r"constexpr double kEps = ([0-9.e+-]+);", src)
    assert len(eps) == 1 and float(eps[0]) == ksnr.EPS == 2.0**-23
    # one instance a speaker count, 1 to kMaxSpeakers, in the entry's switch
    for s in range(1, ksnr.MAX_SPEAKERS):
        assert f"case {s}: return launch_speakers<{s}>(" in src
    assert "case kMaxSpeakers: return launch_speakers<kMaxSpeakers>(" in src
    assert "chunks > 65535" in src and ksnr.MAX_CHUNKS == 65_535
    assert "chunk % 4 == 0" in src and ksnr.VEC == 4
    # the plan's loads a row and cluster shape are the kernel's
    assert "static constexpr int kRowLoads = kLoads / S > 0 ? kLoads / S : 1;" in src
    assert all(ksnr.row_loads(s) == max(1, ksnr.LOADS // s) for s in range(1, ksnr.MAX_SPEAKERS + 1))
    assert ("  if (static_cast<long long>(group) * chunks <= kCluster) return dim3(group, chunks, 1);\n"
            "  return dim3(1, 1, 1);") in src
    assert ksnr.cluster_shape(4, 2) == (2, 4) and ksnr.cluster_shape(12, 1) == (1, 1) and ksnr.CLUSTER <= 8
    # a thread's S^2 + 4 S double sums and its batch of 16-byte loads (2 S rows) stay within 255 registers
    for s in range(1, ksnr.MAX_SPEAKERS + 1):
        assert 2 * (s * s + 4 * s) + 4 * 2 * s * ksnr.row_loads(s) <= 255


def test_sdr_toeplitz_shared_memory_fits_a_block():
    src = _source("sdr_toeplitz")
    # every vector in registers, 3 doubles a slot: E slots a thread within a thread's share of the register file
    assert "  double A[E], B[E], C[E];" in src
    for length in (1, 512, 1024, 1025, 4096, 4097, ksdr.MAX_LENGTH):
        entries, threads = ksdr.plan(length)
        assert 2 * 3 * entries + 16 <= min(255, 65_536 // (1024 if entries <= 2 else 512))
    # no dynamic shared memory: a double-buffered word a warp and the step's three scalars
    assert "extern __shared__" not in src and "<<<static_cast<unsigned int>(rows), threads, 0, stream>>>" in src
    assert "length > kMaxLength" in src
    # the plan's instances and block widths are the launcher's
    assert "constexpr int kBlockThreads = E <= 2 ? kMaxThreads : kMaxThreads / 2;" in src
    assert "return launch_entries<2 * E>(r0, b, sdr, x, rows, length, stream);" in src
    assert "if constexpr (E < 16) {" in src and ksdr.ENTRIES == (1, 2, 4, 8, 16)
    for length in (1, 33, 512, 1024, 1025, 4096, 4097, ksdr.MAX_LENGTH):
        entries, threads = ksdr.plan(length)
        assert threads % 32 == 0 and entries * threads >= length and threads <= (1024 if entries <= 2 else 512)


@pytest.mark.parametrize(("module", "python", "kernel"), [
    (kppl, "THREADS", "kBlockThreads"), (kppl, "WARP_ROW_MAX", "kWarpRowMax"), (kppl, "UNROLL", "kUnroll"),
    (kbm, "BLOCK", "kBlock"), (kbm, "CHUNK", "kChunk"), (kbm, "STAGES", "kStages"), (kbm, "THREADS", "kThreads"),
], ids=lambda v: v if isinstance(v, str) else v.SOURCE)
def test_text_constants_are_the_kernels(module, python, kernel):
    assert getattr(module, python) == _constant(_source(module.SOURCE), kernel)


def test_perplexity_source_matches_its_launcher():
    src = _source("perplexity")
    # the launcher's dtype and target codes are the entry's switch and loads
    assert kppl.KINDS == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    for kind in (0, 1, 2):
        assert f"case {kind}: return launch<{kind}>(" in src
    assert kppl.TARGET_KINDS == {torch.int32: 0, torch.int64: 1} and "target_kind == 0 ?" in src
    # the plan: a block a row past kWarpRowMax, else a warp a row and kBlockThreads / 32 rows a block
    assert "if (v > kWarpRowMax) {" in src and "perplexity_nll_kernel<Kind, kBlockThreads>" in src
    assert "perplexity_nll_kernel<Kind, 32>" in src
    # the last block sets its ticket back to zero (``_build.zero_tickets`` zeroes it once)
    assert "*ticket = 0;" in src and "atomicAdd(ticket, 1)" in src


def test_bert_match_source_matches_its_launcher():
    src = _source("bert_match")
    # the alignment's slack, the stages and the lo parts, then 6 bytes a token of Tp + Tt in dynamic shared memory,
    # opted in past the default 48 KB; the pass's norms and masks and the reductions' scratch are static
    assert "static_cast<size_t>(6) * (tp + tt)" in src and "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    static = 4 * kbm.BLOCK * 4 + 2 * (kbm.THREADS // 32) * 4 + (kbm.THREADS // 32) * 16
    dynamic = 32 * kbm.CHUNK + (kbm.STAGES + 2) * 2 * kbm.BLOCK * kbm.CHUNK * 4  # the swizzle atom: 8 rows
    assert "kAlign + static_cast<size_t>((kStages + 2) * kStageFloats) * sizeof(float)" in src
    assert dynamic + 6 * kbm.MAX_TOKENS + static <= 227 * 1024
    # the products on the tensor cores (wgmma, TF32 operands, one instance a width N) in three passes, each
    # operand split by cvt.rna's rounding (0x1000 added to the bits, the low 13 cleared) as the tests' model does
    for n in (32, 64, 96, 128):
        assert src.count(f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 ") == 1
        assert f"pass<{n}>(s, sh)" in src
    assert src.count("+ 0x1000u) & 0xffffe000u;") == 2
    for product in ("al, bh", "ah, bl", "ah, bh"):
        assert src.count(f"Wgmma<N>::run(acc, {product});") == 1
    # the maxima keep a NaN: no fmaxf among them
    assert "nan_max(" in src and "fmaxf(m" not in src


LIBRARY_CALLS = ("cublas", "cudnn", "cutlass", "torch", "at::", "thrust", "cub::", "matmul", "cross_entropy", "gemm",
                 "scaled_dot_product")


@pytest.mark.parametrize("source", ["perplexity", "bert_match"])
def test_text_kernels_call_no_library(source):
    """The kernels' bodies are written out: no library's product, cross entropy or attention inside."""
    code = "\n".join(line.split("//")[0] for line in _source(source).splitlines())  # the comments name what it replaces
    assert not [name for name in LIBRARY_CALLS if name in code.lower()]


@pytest.mark.parametrize("module", [kppl, kbm], ids=lambda m: m.SOURCE)
def test_text_launchers_do_not_fall_back(module):
    """A CUDA tensor launches the kernel or raises: the launcher holds no ``try`` and never calls the plain version."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    public = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == module.__name__
                  .split(".")[-1].replace("bert_match", "bert_greedy_match").replace("perplexity", "perplexity_nll"))
    calls = {node.func.id for node in ast.walk(public) if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert not [c for c in calls if c.endswith("_plain")]


@pytest.mark.parametrize(("python", "kernel"), [("SHARED_CELLS", "kSharedCells"), ("ROW_THREADS", "kRowThreads"),
                                                ("ELEMENT_THREADS", "kElementThreads")])
def test_confmat_constants_are_the_kernels(python, kernel):
    assert getattr(kcm, python) == _constant(_source("confmat"), kernel)


def test_confmat_source_matches_its_launcher():
    src = _source("confmat")
    # the launch bounds are the plan's block widths, a (C, C) shared histogram fits the default 48 KB
    for kernel, bound in (("rows", "kRowThreads"), ("elements", "kElementThreads"), ("quads", "kElementThreads")):
        assert f"__launch_bounds__({bound}) confmat_{kernel}_kernel(Args a)" in src
    assert 4 * kcm.SHARED_CELLS <= 48 * 1024 and "a.shared && a.cells > kSharedCells" in src
    # the launcher's codes are the entry's switch
    assert kcm.MODES == {"rows": 0, "elements": 1, "labels": 2}
    for kind, code in kcm.PRED_KINDS.items():
        assert f"case {code}: return launch_" in src
    assert kcm.TARGET_KINDS == {torch.int32: 0, torch.int64: 1} and "target_kind == 0 ?" in src
    # scores merge a warp's lanes on one cell everywhere, labels only on the shared histogram; the rows kernel's
    # lane 0 reads the target after the argmax (read before the scores, by every lane, it was no faster:
    # tools/kernel_ablation.py --sections confmat)
    assert "const bool merge = !LABELS || a.shared;" in src and "add_cell(hist, cells[q], true);" in src
    body = src[src.index("confmat_rows_kernel(Args a) {"):src.index("// A thread an element: scores")]
    assert body.index("scan_row(") < body.index("__shfl_xor_sync") < body.index("target[r]")


def test_confmat_calls_no_library():
    """The kernels' bodies are written out: no library call inside."""
    code = "\n".join(line.split("//")[0] for line in _source("confmat").splitlines())
    assert not [name for name in LIBRARY_CALLS if name in code.lower()]


def test_confmat_launcher_does_not_fall_back():
    """A CUDA tensor launches the kernel or raises: no ``try``, no call of the plain version."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(kcm))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    public = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "confmat_multiclass")
    calls = {node.func.id for node in ast.walk(public) if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert not [c for c in calls if c.endswith("_plain")] and "launch_on" in calls


_ABLATION = _ablation()
_BUILDS = [("retrieval", table, name, edits)
           for table in ("RET_PATHS", "RET_BUILDS", "RET_FAULT_BUILDS")
           for name, (edits, _) in getattr(_ABLATION, table).items()]
_BUILDS += [("ssim", "SSIM_VARIANTS", name, edits) for name, (edits, _) in _ABLATION.SSIM_VARIANTS.items()]
_BUILDS += [("pairwise", "PAIRWISE_VARIANTS", name, edits)
            for name, (edits, _) in _ABLATION.PAIRWISE_VARIANTS.items()]
_BUILDS += [("sdr_toeplitz", "SDR_VARIANTS", name, edits) for name, edits in _ABLATION.SDR_VARIANTS.items()]
_BUILDS += [("snr_moments", "SNR_VARIANTS", name, edits) for name, (edits, _) in _ABLATION.SNR_VARIANTS.items()]
_BUILDS += [("bert_match", "BERT_VARIANTS", name, edits) for name, (edits, _) in _ABLATION.BERT_VARIANTS.items()]
_BUILDS += [("confmat", "CONFMAT_VARIANTS", name, edits)
            for name, (edits, *_) in _ABLATION.CONFMAT_VARIANTS.items()]
_BUILDS += [("poly_mmd", "POLY_VARIANTS", name, edits) for name, (edits, *_) in _ABLATION.POLY_VARIANTS.items()]
_BUILDS += [("quantile_hist", "QH_VARIANTS", name, edits) for name, edits in _ABLATION.QH_VARIANTS.items()]


@pytest.mark.parametrize(("source", "table", "name", "edits"), _BUILDS,
                         ids=[f"{table}:{name}" for _, table, name, _ in _BUILDS])
def test_ablation_edits_apply_once(source, table, name, edits):
    text = _source(source)
    for old, new in edits:
        assert text.count(old) == 1, f"{table} {name!r}: {old!r}"
        text = text.replace(old, new)


@pytest.mark.parametrize(("module", "python", "kernel"), [
    (kmi, "THREADS", "kThreads"), (kmi, "GROUP", "kGroup"), (kmi, "IN_FLIGHT", "kInFlight"),
    (kmi, "SHARED_WORDS", "kSharedWords"),
    (kmi, "MAX_MASKS", "kMaxMasks"), (kmi, "MAX_WORDS", "kMaxWords"),
    (kpm, "CONSUMERS", "kConsumers"), (kpm, "PRODUCERS", "kProducers"), (kpm, "CHUNK", "kChunk"),
    (kpm, "ROWS", "kRows"), (kpm, "COLS", "kCols"), (kpm, "STAGES", "kStages"),
    (kpm, "PROMOTE", "kPromote"),
], ids=lambda v: v if isinstance(v, str) else v.SOURCE)
def test_detection_and_generative_constants_are_the_kernels(module, python, kernel):
    assert getattr(module, python) == _constant(_source(module.SOURCE), kernel)


def test_mask_iou_source_matches_its_launcher():
    src = _source("mask_iou")
    # the packed bits and the areas fit the 48 KB of static shared memory; an entry's record is 12 int64
    assert 4 * kmi.SHARED_WORDS + 4 * kmi.MAX_MASKS <= 48 * 1024
    assert "__shared__ unsigned int bits[kSharedWords];" in src
    assert src[src.index("struct Entry {"):src.index("};", src.index("struct Entry {"))].count("long long ") == \
        kmi.ENTRY_FIELDS
    # rows of an odd stride, a group's 16 ballots reached by every lane (the tail's break is warp-uniform),
    # bit ``lane`` of word k pixel 16 lane + k, int32 atomics of non-zero counts
    assert "const int stride = words | 1;" in src and "if (g0 + u >= groups) break;  // warp-uniform" in src
    assert "__ballot_sync(0xffffffffu, ((part[k / 4] >> (8 * (k % 4))) & 0xffu) != 0u)" in src
    assert "const long long px = px0 + static_cast<long long>(g0 + u) * (kGroup * 32) + 16 * lane;" in src
    assert "if (acc) atomicAdd(inter" in src
    # the launcher's plan: rows of an odd stride fit, and every chunk holds whole groups, one at least
    for n_masks in (2, 3, 107, 161, kmi.MAX_MASKS):
        words = kmi.chunk_words(n_masks)
        assert kmi.GROUP <= words <= kmi.MAX_WORDS and words % kmi.GROUP == 0
        assert (words | 1) * n_masks <= kmi.SHARED_WORDS


def test_poly_mmd_source_matches_its_launcher():
    src = _source("poly_mmd")
    # the subsets on grid.y; two producer warpgroups beside two consumer warpgroups; rows split by the kernel
    assert "subsets > 65535" in src and "split(v[ks][e], a[0][ks][e], a[1][ks][e]);" in src
    assert "constexpr int kThreads = kConsumers + kProducers;" in src and kpm.THREADS == 512
    # the roles' registers by setmaxnreg, within an SM's 64 K
    assert 'asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));' in src
    assert 'asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));' in src
    consumer_regs, producer_regs = (int(v) for v in re.findall(
        r"constexpr int kConsumerRegs = (\d+), kProducerRegs = (\d+);", src)[0])
    assert kpm.CONSUMERS * consumer_regs + kpm.PRODUCERS * producer_regs <= 65_536
    assert consumer_regs % 8 == 0 and producer_regs % 8 == 0 and 24 <= producer_regs <= consumer_regs <= 256
    # the dynamic shared memory: the swizzle's slack and the ring's slots of the columns' hi and lo, beside the rows'
    # addresses, within a block's 227 KB; a named barrier pair a slot beside __syncthreads' 0 and the epilogue's
    assert "constexpr int kAlign = 8 * kChunk * 4;" in src and kpm.ALIGN == 8 * kpm.CHUNK * 4
    assert "const int dynamic = kAlign + kStages * 2 * kSlotHalf * static_cast<int>(sizeof(float));" in src
    assert "constexpr int kSlotHalf = kCols * kChunk;" in src
    assert kpm.SHARED_BYTES + 8 * (kpm.ROWS + kpm.COLS) + 8 * kpm.CONSUMERS // 32 + 8 <= 232_448
    assert "constexpr int kFull = 1, kEmpty = 1 + kStages;" in src and 2 + 2 * kpm.STAGES <= 16
    # wgmma m64nNk8, N the tile's columns: TF32 B from shared memory (128-byte rows, the 128-byte swizzle), A from
    # registers; three passes a step of 8, small terms first
    assert f"wgmma.mma_async.sync.aligned.m64n{kpm.COLS}k8.f32.tf32.tf32" in src and kpm.CHUNK == 32
    assert "d |= uint64_t(1) << 62;" in src and "at ^ (((at >> 5) & (kGroups - 1)) << 2)" in src
    assert ("          Wgmma<kCols>::run(acc, a[1][ks], bh);\n          Wgmma<kCols>::run(acc, a[0][ks], bl);\n"
            "          Wgmma<kCols>::run(acc, a[0][ks], bh);") in src
    # the consumers' A fragment (a warp's 16 rows, a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)) from
    # device memory, the next chunk's while this one's products run, split in registers; in the slots' order of a
    # step's features (places j and j + 4 hold features 2 j and 2 j + 1) a row's two are one 8-byte load
    assert "const int k = c * kChunk + 8 * ks + 2 * q;" in src
    assert "const float2 x = load2(row[r], k, t.d, t.vec);" in src
    assert "        v[ks][r] = x.x;\n        v[ks][r + 2] = x.y;" in src
    assert "return 8 * (q >> 1) + 2 * (q & 1);" in src
    assert "*reinterpret_cast<uint2*>(hi + p0) = make_uint2(h.x, h.z);" in src
    assert "*reinterpret_cast<uint2*>(hi + p1) = make_uint2(h.y, h.w);" in src
    assert "Consumer{t, wg, lane & 3, {rows[r_first], rows[r_first + 8]}," in src
    done = src.index("// on every path: chunk c's products are done")
    assert src.index("fetch(c + 1, v);  // while the products run") < done
    # the producers' columns by 16-byte loads, two chunks ahead, split in registers; a warp's load covers whole rows
    assert "return kWarpRows * (p >> 5) + 32 / kGroups * i + (p & 31) / kGroups;" in src
    assert "      put(c, a);\n      fetch(c + 2, a);" in src

    # the ring's barriers: a full one a chunk, an empty one once both warpgroups are done with a slot's products
    assert "bar_sync<kThreads>(kFull + c % kStages);" in src and "bar_arrive<kThreads>(kFull + c % kStages);" in src
    assert "if (c >= kStages) bar_sync<kThreads>(kEmpty + c % kStages);" in src
    assert "if (c + kStages < t.chunks) bar_arrive<kThreads>(kEmpty + c % kStages);" in src
    # the promotion, as the tests' model takes it, once the chunk's products are done
    assert "if ((c + 1) % kPromote == 0) {" in src and "static_assert(kPromote >= 1," in src
    assert done < src.index("if ((c + 1) % kPromote == 0) {")
    # cvt.rna's rounding by an integer add and mask, a NaN kept, lo 0 where hi is not finite; a non-finite
    # product taken again as float32 FMAs in order of k
    assert "hi = x != x ? 0x7fffffffu : (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in src
    assert "lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : (rest + 0x1000u) & 0xffffe000u;" in src
    assert "for (int k = 0; k < d; ++k) dot = __fmaf_rn(a[k], b[k], dot);" in src
    assert "if (!isfinite(dot)) {  // taken again below" in src
    # JAX's rounding: (dot * gamma) + coef rounded twice, the binary power; float64 sums weighing 2 the entries
    # i < j of xx and yy, the last block's exchange leaving the scratch zero and its ticket back at zero
    assert src.count("integer_pow(__fadd_rn(__fmul_rn(dot, gamma), coef), degree)") == 2
    assert "if (i >= m || jj >= m || (symmetric && i >= jj)) continue;" in src
    assert "local *= symmetric ? 2.0 : 1.0;" in src
    assert "atomicExch(reinterpret_cast<unsigned long long*>(sums + 3 * s + w), 0ull)" in src
    assert "tickets[s] = 0u;" in src
    # the accumulators as the tests' model takes them: rows r and r + 8 of a warp's 16, columns 8 j + 2 (lane % 4)
    assert "const int r_first = 64 * wg + 16 * (warp & 3) + (lane >> 2);" in src
    assert "const float dot = acc[4 * j + 2 * half + odd];" in src
    # the blocks of a subset: xy's tiles, then the two upper triangles from column tile first_col_tile(I) on
    assert "for (int i = 0; i < tr; ++i) blocks += 2LL * (tc - first_col_tile(i));" in src
    assert "  tj = first_col_tile(ti) + b;" in src and "return (I * kRows + 1) / kCols;" in src
    assert kpm.tiles(1000) == (8, 8) and kpm.blocks(1000) == 8 * 8 + 2 * 36
    assert kpm.blocks(2) == 1 + 2 and kpm.blocks(129) == 4 + 2 * 3 and kpm.blocks(257) == 9 + 2 * 6


@pytest.mark.parametrize("source", ["mask_iou", "poly_mmd"])
def test_detection_and_generative_kernels_call_no_library(source):
    code = "\n".join(line.split("//")[0] for line in _source(source).splitlines())
    assert not [name for name in LIBRARY_CALLS if name in code.lower()]


@pytest.mark.parametrize(("module", "public"), [(kmi, "mask_iou"), (kpm, "poly_mmd")], ids=["mask_iou", "poly_mmd"])
def test_detection_and_generative_launchers_do_not_fall_back(module, public):
    """A CUDA tensor launches the kernel or raises: the launcher holds no ``try`` and never calls the plain version."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == public)
    calls = {node.func.id for node in ast.walk(fn) if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert not [c for c in calls if c.endswith("_plain")]


@pytest.mark.parametrize(("module", "python", "kernel"), [
    (kqh, "THREADS", "kThreads"), (kqh, "UNROLL", "kUnroll"), (khll, "THREADS", "kThreads"), (khll, "SHARED_PRECISION", "kSharedPrecision"),
], ids=lambda v: v if isinstance(v, str) else v.SOURCE)
def test_sketch_constants_are_the_kernels(module, python, kernel):
    assert getattr(module, python) == _constant(_source(module.SOURCE), kernel)


def test_sketch_sources_match_their_launchers():
    qh, hl = _source("quantile_hist"), _source("hll")
    # quantile_hist: 48 KB of counts a block, JAX's cell rule without a fused multiply-add, int32 counts flushed
    # into the float32 state by one atomic a non-zero count
    assert "constexpr int kSharedBytes = 48 * 1024;" in qh and kqh.SHARED_BYTES == 48 * 1024
    assert "floorf(__fmul_rn(__fsub_rn(v, lo), scale))" in qh
    assert "if (v != 0) atomicAdd(out + i, static_cast<float>(v));" in qh
    assert "chunks > 65535" in qh and kqh.MAX_CHUNKS == 65_535
    # hll: the key chain's salts, the HLL seed's mix, clz of the rest, the last block's total and reset
    assert "h = mix32(static_cast<uint32_t>(t) + h, 0x9E3779B9u * static_cast<uint32_t>(k + 1));" in hl
    assert distinct.KEY_SALT == 0x9E3779B9
    assert "const int rank = rest == 0 ? 33 - a.precision : __clz(rest) + 1;" in hl
    assert "a.total_out[0] = __fadd_rn(a.total_in[0], __ull2float_rn(count));" in hl
    assert "*a.acc = 0;" in hl and "*a.ticket = 0;" in hl


@pytest.mark.parametrize("source", ["quantile_hist", "hll"])
def test_sketch_kernels_call_no_library(source):
    code = "\n".join(line.split("//")[0] for line in _source(source).splitlines())
    assert not [name for name in LIBRARY_CALLS if name in code.lower()]


@pytest.mark.parametrize(("module", "public"), [(kqh, "quantile_hist"), (khll, "hll_insert")],
                         ids=["quantile_hist", "hll_insert"])
def test_sketch_launchers_do_not_fall_back(module, public):
    """A CUDA tensor launches the kernel or raises: the launcher holds no ``try`` and never calls the plain version."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == public)
    calls = {node.func.id for node in ast.walk(fn) if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert not [c for c in calls if c.endswith("_plain")]


def test_int8_codec_constants_are_the_kernels():
    from torchmetrics_tpu_torch.kernels import int8_codec as kic

    src = _source("int8_codec")
    assert kic.THREADS == _constant(src, "kThreads")
    assert "constexpr float kLevels = 127.0f;" in src and "constexpr float kRcpLevels = 1.0f / 127.0f;" in src
    assert kic.RCP_LEVELS == float(torch.tensor(1.0) / torch.tensor(127.0))
    assert "chunk < 8" in src and kic.MIN_CHUNK == 8 and kic.SCALE_BYTES == 4


def test_int8_codec_source_matches_its_plain_version():
    """JAX's arithmetic as the plain version and the tests' model take it: the in-graph scale a multiply by
    float32(1/127), the host scale a division; an IEEE quotient rounded half to even, a NaN code 0; the sum
    fma(q0, s0, q1 s1) then fma(qj, sj, acc), the host's rounded products added into 0; no contraction
    anywhere else (every product and add an explicit rounding intrinsic)."""
    src = _source("int8_codec")
    assert "return host_scale ? __fdiv_rn(m, kLevels) : __fmul_rn(m, kRcpLevels);" in src
    assert "if (nan || !(m > 0.0f)) return 1.0f;" in src
    assert "const float r = rintf(__fdiv_rn(x, scale));" in src and "if (r != r) return 0;" in src
    assert "return static_cast<int8_t>(fminf(fmaxf(r, -kLevels), kLevels));" in src
    assert "m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));" in src and "nan = __any_sync(0xffffffffu, nan);" in src
    assert "float acc = dequantized(packed + (k > 1 ? stride : 0), width, c, chunk, i);" in src
    assert src.count("acc = __fmaf_rn(code(") == 2
    assert "for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, dequantized(packed + j * stride, width, c, chunk, i));" in src
    assert "return __fmul_rn(static_cast<float>(q), load_scale(row + width + 4 * c));" in src
    # the requantize of psum_int8's phase 2 takes the in-graph scale
    assert "const float scale = chunk_scale(m, nan, false);  // the in-graph requantize of psum_int8" in src
    assert "--use_fast_math" not in " ".join(__import__("torchmetrics_tpu_torch.kernels._build",
                                                        fromlist=["NVCC_FLAGS"]).NVCC_FLAGS)


def test_int8_codec_calls_no_library():
    code = "\n".join(line.split("//")[0] for line in _source("int8_codec").splitlines())
    assert not [name for name in LIBRARY_CALLS if name in code.lower()]


@pytest.mark.parametrize("public", ["int8_quantize", "int8_dequant_sum"])
def test_int8_codec_launchers_do_not_fall_back(public):
    """A CUDA tensor launches the kernel or raises: the launcher holds no ``try`` and never calls the plain version."""
    import ast
    import inspect

    from torchmetrics_tpu_torch.kernels import int8_codec as kic

    tree = ast.parse(inspect.getsource(kic))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == public)
    calls = {node.func.id for node in ast.walk(fn) if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert not [c for c in calls if c.endswith("_plain")]


def test_int8_codec_dispatch_is_by_device_alone():
    """The compressed syncs take the kernels on a CUDA tensor and the plain versions on the CPU, by the tensor's
    device and nothing else."""
    import ast
    import inspect

    from torchmetrics_tpu_torch.parallel import compress

    tree = ast.parse(inspect.getsource(compress))
    assert not [node for node in ast.walk(tree) if isinstance(node, ast.Try)]
    for name in ("_quantize_chunks", "_dequantize_chunks"):
        fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == name)
        branch = fn.body[1]
        assert isinstance(branch, ast.If) and ast.unparse(branch.test) in ("blocks.is_cuda", "packed.is_cuda")
