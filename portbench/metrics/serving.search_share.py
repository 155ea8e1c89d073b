"""serving.search_share (%): the dispatcher's seconds in search
(``SearchServer.search_s``, host clock) over the window's seconds."""


def read(run):
    s = run.window.get("server")
    if not s:
        return None
    return 100.0 * s["search_s"] / run.window["seconds"]
