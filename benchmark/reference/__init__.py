"""The benchmark's plain reference: exact Python integers, hashlib, numpy.

It imports nothing of the program under test and takes nothing the program
made: it judges the program's outputs (proof bytes, the statement's trace)
against the configuration file's parameters alone.
"""
