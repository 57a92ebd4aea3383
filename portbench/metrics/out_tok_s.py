"""Tokens emitted by every request in the window over the window's
seconds (host clock; a token counts at the end of the tick that appended
it)."""


def read(obs):
    return obs.tokens / obs.window_s if obs.window_s > 0 else None
