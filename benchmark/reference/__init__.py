"""The plain reference: the conversion's arithmetic (``decimate``), the
containers' layouts (``containers``) and the comparison that decides a
run's ``correct`` (``check``). It imports nothing of the program."""
