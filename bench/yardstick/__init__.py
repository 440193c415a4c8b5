"""The yardstick: the card's published peaks and the operations and bytes
each measured piece of work needs, counted from its shapes."""
