"""Tempo-variation segments a track that exist (``variation_segments``,
counted on the ``grid.variation`` spans of the window's calls) over the
window's tracks: how much of each track the variation check reads. None
where nothing counted them (a port without the counter)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    return spans.per(spans.counted(spans.in_roots(recs), "variation_segments") or None,
                     spans.tracks(recs))
