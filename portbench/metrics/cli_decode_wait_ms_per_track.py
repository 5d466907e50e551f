"""Host milliseconds a file that the batch CLI's main thread waits on its
decode queue: the host time of the ``cli.wait`` spans over the files of the
window's ``cli.decode`` spans."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    files = sum(int(r["attrs"].get("files", 0)) for r in spans.named(recs, "cli.decode"))
    return spans.per(spans.host_ms(recs, "cli.wait"), files)
