"""Mean prompts a prefill batch served, from the program's responses
(each carries its batch's size): prompts over batches."""


def read(r):
    sizes = r.items("prefill")
    return len(sizes) / sum(1.0 / b for b in sizes) if sizes else None
