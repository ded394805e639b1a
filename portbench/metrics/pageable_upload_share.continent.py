"""The share of the band uploads' bytes that left pageable host memory in the
traced pass, in %: `continent.upload_bytes.pageable` over it plus
`continent.upload_bytes.pinned` (the program counts each upload by its host
copy's `is_pinned()`)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    c = snap["counters"]
    pageable, pinned = c.get("continent.upload_bytes.pageable"), c.get(
        "continent.upload_bytes.pinned")
    if pageable is None and pinned is None:
        return None
    pageable, pinned = pageable or 0, pinned or 0
    return 100.0 * pageable / (pageable + pinned)
