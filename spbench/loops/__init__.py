"""One module a loop kind, named by a traffic file's ``loop`` key, with its
plain reference beside it (``<loop>_ref.py``)."""
