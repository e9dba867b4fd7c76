"""md.steps_per_rebuild: mean steps of the window's ``run_device`` segments
(``MDResult.segments``; a segment ends at a neighbor-list rebuild)."""


def read(name, rec):
    seg = rec['stats'].get('segments')
    return sum(seg) / len(seg) if seg else None
