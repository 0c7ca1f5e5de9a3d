"""Operations and bytes that the work needs, counted from shapes and valid
lengths: padding rows, padded frames and bucket windows count nothing.

Roofline of a call: the larger of bytes / HBM rate and operations / the
dtype's peak, each input byte read once and each output byte written once.
"""

from __future__ import annotations

from yardstick.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take for (bytes, operations)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def attention_cost(lengths: list[int], H: int, Dh: int, in_dtype: str, out_dtype: str
                   ) -> tuple[int, int]:
    """(bytes, operations) of one rel-pos attention call over its valid rows:
    row b has lengths[b] queries and keys; q.k, the shifted q.p band and P.V
    each 2 L^2 Dh per head; qu, qw, k, v and the output of the valid rows and
    the 2 Lmax - 1 position rows moved once."""
    i, o = DTYPE_BYTES[in_dtype], DTYPE_BYTES[out_dtype]
    rows = [n for n in lengths if n > 0]
    if not rows:
        return 0, 0
    lmax = max(rows)
    nbytes = sum(4 * n * H * Dh * i + n * H * Dh * o for n in rows)
    nbytes += H * (2 * lmax - 1) * Dh * i + 4 * len(rows)
    return nbytes, sum(6 * n * n * H * Dh for n in rows)


def conv_out(n: int) -> int:
    """Length after one k=3, stride-2, pad-1 convolution."""
    return (n + 2 - 3) // 2 + 1


def mel_flops(frames: int, n_fft: int = 512, win: int = 400, n_mels: int = 128) -> int:
    """Windowed real DFT over `win` samples into n_fft//2+1 bins, then the
    filterbank, per frame."""
    bins = n_fft // 2 + 1
    return frames * (2 * win * 2 * bins + 2 * bins * n_mels)


def conformer_flops(mel_frames: int, enc: dict) -> int:
    """FastConformer encoder over one row with `mel_frames` valid frames: the
    dw-striding subsampling, then per block two FFNs, the q/k/v/out and
    position projections, the attention core and the conv module."""
    d, C, k, n_mels = enc["d_model"], enc["subsampling_channels"], enc["conv_kernel"], \
        enc["n_mels"]
    t1, f1 = conv_out(mel_frames), conv_out(n_mels)
    t2, f2 = conv_out(t1), conv_out(f1)
    L, f3 = conv_out(t2), conv_out(f2)
    sub = (2 * 9 * C * t1 * f1
           + 2 * 9 * C * t2 * f2 + 2 * C * C * t2 * f2
           + 2 * 9 * C * L * f3 + 2 * C * C * L * f3
           + 2 * C * f3 * d * L)
    ff = enc.get("ffn_expansion", 4)
    block = (2 * 2 * 2 * L * d * ff * d  # ffn1, ffn2: fc1 + fc2
             + 4 * 2 * L * d * d  # q, k, v, out
             + 2 * (2 * L - 1) * d * d  # position projection
             + 6 * L * L * d  # q.k, q.p band, P.V
             + 2 * L * d * 2 * d + 2 * L * d * k + 2 * L * d * d)  # conv module
    return sub + enc["n_layers"] * block


def sortformer_head_flops(frames: int, head: dict) -> int:
    """encoder_proj, the transformer stack over `frames` positions, the
    hidden layer and the 4-slot head."""
    d, e, N = head["d_model"], head["encoder_d_model"], frames
    layer = 4 * 2 * N * d * d + 2 * 2 * N * N * d + 2 * 2 * N * d * 4 * d
    return 2 * N * e * d + head["n_transformer_layers"] * layer + 2 * N * d * d + 2 * N * d * 4
