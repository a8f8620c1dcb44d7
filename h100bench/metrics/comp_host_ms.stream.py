"""The compressor stage of the live chain (compressor_stream on kernel B),
host clock of the program's span stream.compressor, with no synchronize
inside, over its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["stream.compressor"], "stream.compressor")
