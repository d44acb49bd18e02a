"""setup_s: seconds from the process's start to the window's (imports, the
kernels loaded, the views rendered and written, the warm-up job)."""


def read(record):
    return record["setup_s"]
