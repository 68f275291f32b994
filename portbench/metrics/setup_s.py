"""setup_s (s, host clock): process start to window start: imports,
inputs, the program's set-up, first-run kernel builds and warm-up."""


def read(rec):
    return rec["setup_s"]
