"""recall10 (ratio): recall@10 of the window's answers against the
reference's exact top 10 over the live rows (the churn cell: of the
configuration's queries on the index as the window left it)."""


def read(run):
    return run.judged.get("recall10")
