"""place_ms: host clock from the first pod's /filter to the last pod's
Allocate answer (the extender's webhooks, the plugin's Allocate)."""


def read(ctx):
    return ctx.place_ms
