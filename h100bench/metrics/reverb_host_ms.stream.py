"""The reverb stage of the live chain (reverb_stream, overlap-save by the
IR's spectrum), host clock of the program's span stream.reverb, with no
synchronize inside, over its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["stream.reverb"], "stream.reverb")
