"""The general generators: each drives one kind of mix, named by a traffic file's ``driver``."""
