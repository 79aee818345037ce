"""The yardstick of the roofline and peak metrics: one H100's peaks, the
least time some work could take on it, and the operations and bytes of
the program's greedy suppression kernel (kernel 1), from its shapes.

Copied, so that a change to the program cannot move the yardstick, from
watsor_tpu_torch/workload.py (``Bound``, the peaks, ``fixed_point_work``
and its ``IOU_OPS``).
"""

# one H100 SXM at 700 W, NVIDIA's data sheet, dense rates
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {'bf16': 989e12, 'f32': 67e12, 'tf32': 495e12,
              'int8': 1979e12}

# f32 operations of one IoU and its compare against the threshold: four
# min/max, two differences and their clamps, the product, the union's add,
# subtract and clamp, the division and the compare
IOU_OPS = 14


class Bound:
    """The least time the card could take for some work: the bytes moved
    once over the memory rate against the operations over the peak rate of
    their type, the larger of the two. Calls add up."""

    def __init__(self):
        self.bytes_ms = 0.0
        self.ops_ms = 0.0

    def add(self, nbytes, **ops):
        self.bytes_ms += 1e3 * nbytes / HBM_BYTES_S
        self.ops_ms += max([1e3 * n / PEAK_OPS_S[kind]
                            for kind, n in ops.items()] + [0.0])
        return self

    @property
    def ms(self):
        return max(self.bytes_ms, self.ops_ms)

    @property
    def by(self):
        return 'bytes' if self.bytes_ms >= self.ops_ms else 'operations'


def fixed_point_work(B, C, M):
    """(bytes, f32 operations) of one greedy suppression over the NMS
    union (kernel 1): f32 scores [B, C, M] and boxes [B, M, 4] read once,
    the keep bytes written once; each image's M(M-1)/2 IoUs, shared by its
    classes."""
    return 4 * (B * C * M + 4 * B * M) + B * C * M, \
        IOU_OPS * B * M * (M - 1) // 2

