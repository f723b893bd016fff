"""Cost of one streaming block of the modal bank's rotation kernel
(``gpuab::modal_bank_launch`` on amp-prefolded states): a copy of
``gpuaudiobench_tpu_torch/models/modal.py:cost_model`` with one change.

Per mode and sample the folded step rotates the phasor, re' = re c -
im s and im' = re s + im c (4 multiplies and 2 adds), and adds re' onto
its track: 7 FP32 operations. The program's count is 8, for the amp
multiply of the unfolded form, which the folded step does not make.
Bytes: the four tables and states read once (cos, sin, re, im), the two
states written once, and the (S, T_out) output written once.
"""

NAMES = ("modal_bank_kernel", "modal_bank_reduce")


def cost(conf) -> dict:
    t = conf["output_tracks"]
    m = -(-conf["modes"] // t) * t  # padded onto whole tracks
    s = conf["buffer_size"]
    return {"flops": 7 * m * s, "bytes": (4 * m + 2 * m + s * t) * 4}
