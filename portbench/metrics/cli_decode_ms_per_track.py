"""Host milliseconds a file of the batch CLI's decode, in its decode thread:
the host time of the ``cli.decode`` spans over the files they decoded."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    decodes = spans.named(recs, "cli.decode")
    files = sum(int(r["attrs"].get("files", 0)) for r in decodes)
    return spans.per(spans.host_ms(recs, "cli.decode"), files)
