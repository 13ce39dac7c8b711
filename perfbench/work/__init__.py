"""Frozen work counts: the operations and bytes each measured piece of
work needs, from shapes alone, and the card's published peaks."""
