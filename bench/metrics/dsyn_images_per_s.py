"""dsyn_images_per_s: images delivered to their requests inside the window,
over the window's seconds.  The window opens and closes at wave boundaries
and every wave is whole requests, so it counts whole waves only, and a
stall anywhere inside it lowers the rate."""


def read(ctx):
    f = ctx["facts"]
    if "images" not in f:
        return None
    return f["images"] / ctx["seconds"]
