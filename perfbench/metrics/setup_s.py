"""Set-up time: process start to the start of the measured window
(imports, the kernel build where the checkout has none yet, weights,
data, warm-up), host clock."""


def read(run):
    return run.setup_s
