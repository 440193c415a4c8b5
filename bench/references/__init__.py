"""Plain references the check holds the program against: plain torch, no
import of the program."""
