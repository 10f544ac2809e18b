"""The yardstick's arithmetic: the operations and bytes that a step
needs, worked out from the cell's shapes whatever kernel computes them,
and the card's published peaks."""
