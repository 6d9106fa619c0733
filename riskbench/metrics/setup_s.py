"""setup_s: process start to the window's start (imports, CUDA context,
the book, the path kernel's library, one warm-up run), host clock."""


def read(record):
    return record.setup_s
