"""Faults planted in the program's path of an rndmem_65536 stream, where
each produces its output: the step of ``models/rndmem.py`` and its
gather. Each ``FAULTS`` entry takes ``patch(owner, name, value)`` and
plants the fault with it."""


def _unchanged(patch):
    """The step returns the playheads it was given."""
    from gpuaudiobench_tpu_torch.models import rndmem

    body = rndmem.RndMemBenchmark.stream_body

    def stuck(self):
        step, carry = body(self)
        return (lambda ph: (ph, step(ph)[1])), carry

    patch(rndmem.RndMemBenchmark, "stream_body", stuck)


def _gather(kind):
    def plant(patch):
        from gpuaudiobench_tpu_torch.models import rndmem
        from gpuaudiobench_tpu_torch.ops.rndmem import rndmem_gather

        def gather(pool, ph, s):
            out = rndmem_gather(pool, ph, s).clone()
            if kind == "half":  # half the voices stand in for the rest
                h = out.shape[1] // 2
                out[:, h:] = out[:, :h]
            else:
                out[0, 0] += 1.0  # one sample altered
            return out

        patch(rndmem, "rndmem_gather", gather)

    return plant


FAULTS = {"unchanged": _unchanged, "half": _gather("half"),
          "altered": _gather("altered")}
